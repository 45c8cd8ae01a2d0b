"""Point Transformer V3 (Wu et al., CVPR 2024, arXiv:2312.10035; Pointcept
`point_transformer_v3m1_base.py`) ending in SmartTree's heads: the plain
reference (reference/ptv3.py, one tile block at a time), its operation
count, and seeded weights in the layout of the program's PTv3 checkpoints
(`params/...`, `batch_stats/...` and `config/...` arrays)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from reference.forward import Heads
from reference.ptv3 import PTv3, forward_blocks, load_checkpoint, neighbour_table
from reference.tiling import voxelize_cloud
from stbench import flops, generator

HEAD_NAMES = ("radius_head", "direction_head", "class_head")
# the tree whose activations set a draw's batch norm statistics
CALIBRATION_TREE = {"height": 3.0, "trunk_radius": 0.1, "points_per_m2": 2000.0,
                    "foliage_points": 2000}


@dataclass
class Linear:
    """A per-voxel linear layer (bias added): rows x cin -> cout."""

    rows: int
    cin: int
    cout: int
    k3: None = None

    def flops(self):
        return 2 * self.rows * self.cin * self.cout

    def bytes(self, width):
        return width * (self.rows * self.cin + self.cin * self.cout + self.rows * self.cout)

    def bound_s(self, precision):
        return _bound(self, precision)


@dataclass
class Attention:
    """One patch's attention: `queries` rows whose output is kept against
    `keys` rows, over `width` channels (all heads): Q K^T and the weights
    times V, 2 x queries x keys x width operations each; Q and O of the
    queries, K and V of the keys read or written once."""

    queries: int
    keys: int
    width: int
    k3: None = None
    kind: str = "attention"

    def flops(self):
        return 4 * self.queries * self.keys * self.width

    def bytes(self, width):
        return width * self.width * 2 * (self.queries + self.keys)

    def bound_s(self, precision):
        return _bound(self, precision)


def _bound(op, precision):
    return max(op.flops() / flops.PEAK_FLOPS[precision],
               op.bytes(flops.WIDTH[precision]) / flops.PEAK_BYTES)


def _heads(model):
    return tuple(tuple(h) for h in model["head_planes"])


def _levels(coords, n_levels, device):
    """Each level's int64 coords of one block, level l + 1 the cells
    coords >> 1 of level l."""
    levels = [torch.as_tensor(coords, dtype=torch.int64, device=device)]
    for _ in range(n_levels - 1):
        levels.append(torch.unique(levels[-1] >> 1, dim=0))
    return levels


def _patches(n, patch):
    """(queries, keys) of each patch of a run of n voxels."""
    if n <= patch:
        return [(n, n)]
    p = -(-n // patch)
    return [(patch, patch)] * (p - 1) + [(n - (p - 1) * patch, patch)]


def forward(xyz, model, device="cpu", mode=None) -> Heads:
    """The heads of every interior voxel of `xyz` [N,3] float32 under the
    configuration's `model` section; `mode` as `reference/unet.py::_round`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vox = voxelize_cloud(xyz, model["voxel_size"], model["block_size"], model["buffer_size"])
    net = PTv3(load_checkpoint(model["weights"]), device, mode)
    r, d, dn, logits = forward_blocks(net, vox.coords, torch.from_numpy(vox.feats).to(device),
                                      vox.side)
    keep = vox.interior
    return Heads(vox.point[keep], r[keep], d[keep], dn[keep], logits[keep])


def inventory(xyz, model, device="cpu"):
    """Every operation of one forward over the voxels of `xyz`, block by
    block: the stem (125 columns) and CPE (27) convs by the neighbour pairs
    that exist, the linears (`Linear`), each patch's attention
    (`Attention`) and the heads' 1 x 1 convs."""
    vox = voxelize_cloud(xyz, model["voxel_size"], model["block_size"], model["buffer_size"])
    enc, dec = model["enc_channels"], model["dec_channels"]
    widths = [[enc[lvl]] * model["enc_depths"][lvl]
              + ([dec[lvl]] * model["dec_depths"][lvl] if lvl < len(dec) else [])
              for lvl in range(len(enc))]
    r, k, cin = model["mlp_ratio"], model["stem_kernel"], model["input_channels"]
    coarse = list(dec[1:]) + [enc[-1]]
    ops = []
    coords = torch.as_tensor(vox.coords, dtype=torch.int64)
    for b in torch.unique(coords[:, 0]).tolist():
        levels = _levels(coords[coords[:, 0] == b, 1:], len(enc), device)
        n = [len(lv) for lv in levels]
        pairs = [int((neighbour_table(lv, 3) >= 0).sum()) for lv in levels]
        ops.append(flops.Conv(int((neighbour_table(levels[0], k) >= 0).sum()), n[0], n[0], cin,
                              enc[0], k ** 3))
        for lvl, ws in enumerate(widths):
            for c in ws:
                ops.append(flops.Conv(pairs[lvl], n[lvl], n[lvl], c, c, 27))
                ops += [Linear(n[lvl], c, c), Linear(n[lvl], c, 3 * c), Linear(n[lvl], c, c),
                        Linear(n[lvl], c, r * c), Linear(n[lvl], r * c, c)]
                ops += [Attention(q, kk, c) for q, kk in _patches(n[lvl], model["patch_size"])]
            if lvl:
                ops.append(Linear(n[lvl - 1], enc[lvl - 1], enc[lvl]))            # pooling
            if lvl < len(dec):
                ops += [Linear(n[lvl + 1], coarse[lvl], dec[lvl]),                # unpooling
                        Linear(n[lvl], enc[lvl], dec[lvl])]
        for head in _heads(model):
            ops += [flops.Conv(n[0], n[0], n[0], a, c, 1) for a, c in zip(head[:-1], head[1:])]
    return ops


def layout(model):
    """{checkpoint key: shape} of the network at the configuration's widths."""
    enc, dec = model["enc_channels"], model["dec_channels"]
    r = model["mlp_ratio"]
    out = {}

    def bn(path, c):
        for leaf in ("scale", "bias"):
            out[f"params/{path}/{leaf}"] = (c,)
        for leaf in ("mean", "var"):
            out[f"batch_stats/{path}/{leaf}"] = (c,)

    def ln(path, c):
        for leaf in ("scale", "bias"):
            out[f"params/{path}/{leaf}"] = (c,)

    def lin(path, a, b):
        out[f"params/{path}/weight"] = (a, b)
        out[f"params/{path}/bias"] = (b,)

    def blocks(part, s, c, depth):
        for i in range(depth):
            p = f"{part}/{s}/blocks/{i}"
            out[f"params/{p}/cpe/conv/weight"] = (27, c, c)
            out[f"params/{p}/cpe/conv/bias"] = (c,)
            lin(f"{p}/cpe/linear", c, c)
            ln(f"{p}/cpe/norm", c)
            ln(f"{p}/norm1", c)
            lin(f"{p}/attn/qkv", c, 3 * c)
            lin(f"{p}/attn/proj", c, c)
            ln(f"{p}/norm2", c)
            lin(f"{p}/mlp/fc1", c, r * c)
            lin(f"{p}/mlp/fc2", r * c, c)

    out["params/embedding/conv/weight"] = (model["stem_kernel"] ** 3, model["input_channels"],
                                           enc[0])
    bn("embedding/norm", enc[0])
    for s, (c, depth) in enumerate(zip(enc, model["enc_depths"])):
        if s:
            lin(f"enc/{s}/down/linear", enc[s - 1], c)
            bn(f"enc/{s}/down/norm", c)
        blocks("enc", s, c, depth)
    coarse = list(dec[1:]) + [enc[-1]]
    for s, (c, depth) in enumerate(zip(dec, model["dec_depths"])):
        lin(f"dec/{s}/up/proj/linear", coarse[s], c)
        bn(f"dec/{s}/up/proj/norm", c)
        lin(f"dec/{s}/up/skip/linear", enc[s], c)
        bn(f"dec/{s}/up/skip/norm", c)
        blocks("dec", s, c, depth)
    for name, widths in zip(HEAD_NAMES, _heads(model)):
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            out[f"params/{name}/sequence.{3 * i}.weight"] = (1, a, b)
            if i < 2:
                bn(f"{name}/sequence.{3 * i + 1}", b)
    out["config/head_dim"] = ()
    out["config/patch_size"] = ()
    return out


class _Calibrate(PTv3):
    """The network normalising each batch norm's input by its own mean and
    variance over the block's rows, and pooling those over the blocks into
    running statistics (`stats`)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.stats = {}

    def _bn(self, x, path, eps):
        s = self.stats.setdefault(path, [0, 0.0, 0.0])
        s[0] += x.shape[0]
        s[1] = s[1] + x.sum(dim=0)
        s[2] = s[2] + (x * x).sum(dim=0)
        mean, var = x.mean(dim=0), x.var(dim=0, unbiased=False)
        return (x - mean) * (torch.rsqrt(var + eps) * self._w(f"{path}/scale")) \
            + self._w(f"{path}/bias")


def draw(model, seed):
    """Seeded weights at the configuration's widths. Convs and linears
    N(0, 1 / fan in) (fan in the conv's columns times its input channels),
    their biases N(0, 0.1^2); LayerNorm at scale 1, bias 0; batch norm
    scales near 1 and biases near 0; the heads as SmartTree's draw
    (N(0, 2 / fan in), the output layers centred over their inputs), the
    direction head's output layer at twice that scale, so that most rows'
    direction reads a norm of 1 or more (stbench/check.py's DEAD). The
    running statistics are pooled over the blocks of one pass in
    batch-statistics mode over a tree drawn from the seed
    (stbench/generator.py), so that every batch norm's input is centred and
    of unit scale, and no head collapses to one class."""
    head_dim = {c // h for c, h in zip(model["enc_channels"] + model["dec_channels"],
                                       model["enc_num_head"] + model["dec_num_head"])}
    if len(head_dim) != 1:
        raise ValueError(f"heads of one width only, got {sorted(head_dim)}")
    config = {"config/head_dim": head_dim.pop(), "config/patch_size": model["patch_size"]}
    shapes = layout(model)
    bn = {k.split("/", 1)[1].rsplit("/", 1)[0] for k in shapes if k.startswith("batch_stats/")}
    ln = {k.split("/", 1)[1].rsplit("/", 1)[0] for k in shapes
          if k.endswith("/scale")} - bn
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in shapes.items():
        collection, rest = key.split("/", 1)
        path, leaf = rest.rsplit("/", 1) if "/" in rest else ("", rest)
        if collection == "config":
            v = np.asarray(config[key], np.float64)
        elif collection == "batch_stats":
            v = np.zeros(shape) if leaf == "mean" else np.ones(shape)
        elif path in bn:
            v = 1.0 + 0.1 * rng.standard_normal(shape) if leaf == "scale" \
                else 0.1 * rng.standard_normal(shape)
        elif path in ln:
            v = np.ones(shape) if leaf == "scale" else np.zeros(shape)
        elif leaf.endswith("weight"):
            gain = 2.0 if path in HEAD_NAMES else 1.0
            if path == "direction_head" and leaf == "sequence.6.weight":
                gain = 8.0
            v = rng.standard_normal(shape) * np.sqrt(gain / int(np.prod(shape[:-1])))
            if leaf == "sequence.6.weight":
                v -= v.mean(axis=1, keepdims=True)
        else:
            v = 0.1 * rng.standard_normal(shape)
        out[key] = v.astype(np.float32)
    xyz, _ = generator.generate_tree(seed=seed, **CALIBRATION_TREE)
    vox = voxelize_cloud(generator.centre(xyz), model["voxel_size"], model["block_size"],
                         model["buffer_size"])
    net = _Calibrate({k: torch.from_numpy(v) for k, v in out.items()}, "cpu")
    forward_blocks(net, vox.coords, torch.from_numpy(vox.feats), vox.side)
    for path, (n, s1, s2) in net.stats.items():
        mean = s1 / n
        out[f"batch_stats/{path}/mean"] = mean.numpy().astype(np.float32)
        out[f"batch_stats/{path}/var"] = (s2 / n - mean * mean).clamp_min(0).numpy() \
            .astype(np.float32)
    return out
