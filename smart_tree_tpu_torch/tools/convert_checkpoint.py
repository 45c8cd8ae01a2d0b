"""Convert a reference spconv checkpoint (`.pt` state_dict) to the `.npz`
flax-variable layout that both packages load (counterpart of
`tools/convert_checkpoint.py`). The model's widths come from the
checkpoint's shapes; the variable tree is the port's own model's, so no
template network is built. Host only: nothing here runs on a device.

    python -m smart_tree_tpu_torch.tools.convert_checkpoint \\
        noble-elevator-58_model_weights.pt smart_tree_tpu/weights/noble-elevator-58.npz
"""

from __future__ import annotations

import argparse

import torch

from ..nn.convert import (convert_state_dict, model_from_state_dict_shapes, save_npz,
                          variables_from_model)


def _fc_planes(head) -> tuple:
    """A head's widths, input first, from its [K3, Cin, Cout] weights."""
    ws = [w for w in head.parameters() if w.ndim == 3]
    return (int(ws[0].shape[1]),) + tuple(int(w.shape[2]) for w in ws)


def convert(src, dst) -> None:
    # weights_only: tensors only, no pickled code runs
    sd = torch.load(src, map_location="cpu", weights_only=True)
    model = model_from_state_dict_shapes(sd)
    r, d, c = (_fc_planes(h) for h in (model.radius_head, model.direction_head,
                                        model.class_head))
    print(f"model: planes={model.unet_planes} in={model.input_channels} "
          f"heads r={r} d={d} c={c}")
    model.load_state_dict(convert_state_dict(sd, model), strict=True)
    save_npz(dst, variables_from_model(model))
    print(f"wrote {dst}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", help="reference state_dict (.pt)")
    ap.add_argument("dst", help="checkpoint to write (.npz)")
    args = ap.parse_args(argv)
    convert(args.src, args.dst)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
