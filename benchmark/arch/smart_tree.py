"""SmartTree's sparse UNet (uc-vision/smart-tree), the architecture of a
configuration that names none: the plain reference (reference/unet.py), its
operation count (stbench/flops.py) and seeded weights in the layout of the
shipped checkpoints (flax paths, `params/...` and `batch_stats/...`)."""

from __future__ import annotations

import numpy as np
import torch

from reference.forward import Heads
from reference.tiling import voxelize_cloud
from reference.unet import UNet, build_levels, load_checkpoint
from stbench import flops, generator

HEAD_NAMES = ("radius_head", "direction_head", "class_head")
# the tree whose activations set a draw's batch norm statistics
CALIBRATION_TREE = {"height": 5.0, "trunk_radius": 0.15, "points_per_m2": 2000.0,
                    "foliage_points": 2000}


def _planes(model):
    return tuple(model["planes"])


def _heads(model):
    """Each head's widths, level 0's planes in: those of the shipped
    checkpoints (flops.HEADS) at the configuration's planes."""
    return tuple((_planes(model)[0],) + h[1:] for h in flops.HEADS)


def forward(xyz, model, device="cpu", mode=None) -> Heads:
    """The heads of every interior voxel of `xyz` [N,3] float32 under the
    configuration's `model` section; `mode` as `unet._round`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vox = voxelize_cloud(xyz, model["voxel_size"], model["block_size"], model["buffer_size"])
    net = UNet(load_checkpoint(model["weights"]), device, mode)
    levels = build_levels(vox.coords, vox.side, n_levels=len(_planes(model)), device=device)
    order = levels[0].order.cpu().numpy()
    feats = torch.from_numpy(vox.feats[order]).to(device)
    r, d, dn, logits = (t.float().cpu().numpy() for t in net(levels, feats))
    keep = vox.interior[order]
    return Heads(vox.point[order][keep], r[keep], d[keep], dn[keep], logits[keep])


def inventory(xyz, model, device="cpu"):
    """Every conv of one forward over the voxels of `xyz`."""
    vox = voxelize_cloud(xyz, model["voxel_size"], model["block_size"], model["buffer_size"])
    levels = build_levels(vox.coords, vox.side, n_levels=len(_planes(model)), device=device)
    return flops.inventory(levels, planes=_planes(model),
                           in_channels=model.get("input_channels", 3), heads=_heads(model))


def layout(model):
    """{checkpoint key: shape} of the network at the configuration's widths."""
    planes = _planes(model)
    out = {}

    def bn(path, c):
        for leaf in ("scale", "bias"):
            out[f"params/{path}/{leaf}"] = (c,)
        for leaf in ("mean", "var"):
            out[f"batch_stats/{path}/{leaf}"] = (c,)

    def res(path, a, b):
        out[f"params/{path}/sequence.0/weight"] = (27, a, b)
        bn(f"{path}/sequence.1", b)
        out[f"params/{path}/sequence.3/weight"] = (27, b, b)
        bn(f"{path}/sequence.4", b)
        if a != b:
            out[f"params/{path}/identity.0/weight"] = (1, a, b)

    out["params/input_conv.sequence/0/weight"] = (1, model.get("input_channels", 3), planes[0])
    bn("input_conv.sequence/1", planes[0])
    path = "UNet"
    for lvl, p in enumerate(planes):
        res(f"{path}/Head", p, p)
        if lvl + 1 < len(planes):
            q = planes[lvl + 1]
            out[f"params/{path}/Encode.sequence/0/weight"] = (27, p, q)
            bn(f"{path}/Encode.sequence/1", q)
            out[f"params/{path}/Decode.sequence/0/weight"] = (27, q, p)
            bn(f"{path}/Decode.sequence/1", p)
            res(f"{path}/Tail", 2 * p, p)
        path += "/U"
    for name, widths in zip(HEAD_NAMES, _heads(model)):
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            out[f"params/{name}/sequence.{3 * i}.weight"] = (1, a, b)
            if i < 2:
                bn(f"{name}/sequence.{3 * i + 1}", b)
    return out


class _Calibrate(UNet):
    """The network with each batch norm's running statistics set, as it
    is reached, to the mean and variance of its input over the rows."""

    def _bn(self, x, path):
        self.p[f"batch_stats/{path}/mean"] = x.mean(dim=0)
        self.p[f"batch_stats/{path}/var"] = x.var(dim=0, unbiased=False)
        return super()._bn(x, path)


def draw(model, seed):
    """Seeded weights at the configuration's widths. Each conv N(0, 2 / fan
    in), fan in its columns times its input channels, the heads' output
    layers centred over their inputs; batch norm scales near 1 and biases
    near 0. The running statistics are those of one pass in batch-statistics
    mode over a tree drawn from the seed (stbench/generator.py), so that
    every batch norm's input is centred and of unit scale, and no head
    collapses to one class or one radius."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in layout(model).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf.endswith("weight"):
            v = rng.standard_normal(shape) * np.sqrt(2.0 / (shape[0] * shape[1]))
            if leaf == "sequence.6.weight":
                v -= v.mean(axis=1, keepdims=True)
        elif leaf == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == "bias":
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = np.zeros(shape) if leaf == "mean" else np.ones(shape)
        out[key] = v.astype(np.float32)
    xyz, _ = generator.generate_tree(seed=seed, **CALIBRATION_TREE)
    vox = voxelize_cloud(generator.centre(xyz), model["voxel_size"], model["block_size"],
                         model["buffer_size"])
    net = _Calibrate({k: torch.from_numpy(v) for k, v in out.items()}, "cpu")
    levels = build_levels(vox.coords, vox.side, n_levels=len(_planes(model)))
    net(levels, torch.from_numpy(vox.feats[levels[0].order.numpy()]))
    for k in out:
        if k.startswith("batch_stats/"):
            out[k] = net.p[k].numpy().astype(np.float32)
    return out
