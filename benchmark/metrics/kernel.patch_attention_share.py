"""The attention kernels' share of the device's kernel time over the
traced clouds, in %: the seconds of the kernels `scaled_dot_product_attention`
launched (kernel.patch_attention_roofline's ATTENTION_KERNELS) over the
seconds of every kernel. Nothing without a trace or where none ran."""

ATTENTION_KERNELS = ("flash_fwd", "fmha_cutlass", "native_sdpa")


def read(rec):
    if not rec.trace:
        return None
    kernels = rec.trace["kernel_s"]
    spent = sum(s for name, s in kernels.items() if any(f in name for f in ATTENTION_KERNELS))
    total = sum(kernels.values())
    if spent <= 0 or total <= 0:
        return None
    return 100.0 * spent / total
