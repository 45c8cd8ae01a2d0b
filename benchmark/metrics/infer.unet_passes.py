"""UNet passes per cloud (`ModelInference.plan_rows`: one exact plan a
batch, two where a batch was split to fit the budget), the mean over the
window."""


def read(rec):
    return rec.mean("unet_passes")
