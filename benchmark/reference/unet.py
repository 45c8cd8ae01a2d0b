"""Plain reference, part 2: the SmartTree sparse UNet in float32 PyTorch.

Written from the published architecture (uc-vision/smart-tree, spconv
SubMConv3d / SparseConv3d(k=3, s=2, p=1) / SparseInverseConv3d) and the
checkpoint's own arrays, read from the `.npz` here: no kernel, plan, cache or
batching of the program. Every neighbour is found by a binary search over
the sorted voxel keys of its level, and every conv is a gather of the 27
neighbours (a zero row where there is none) times the [27 * Cin, Cout]
weight, with TF32 switched off.

`mode` rounds the operands of every product to a lower precision: "tf32"
(10 mantissa bits, round to nearest) or "fp8" (e4m3 with one scale per
tensor, its largest magnitude at 448) for the control of the correctness
check, "bf16" for the tests that hold the program's bfloat16 path to it.
The accumulation stays float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

ROW_CHUNK = 1 << 16
_SHIFT = (30, 20, 10)      # block, x, y bit offsets of a key; z takes bits 0-9


def load_checkpoint(path):
    """{flax path: float32 tensor} of a `.npz` checkpoint."""
    with np.load(path) as z:
        return {k: torch.from_numpy(np.asarray(z[k], np.float32)) for k in z.files}


def _key(c):
    return (c[:, 0] << _SHIFT[0]) | (c[:, 1] << _SHIFT[1]) | (c[:, 2] << _SHIFT[2]) | c[:, 3]


def _offsets(device):
    r = torch.arange(3, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 3)


def _lookup(keys, q, ok):
    pos = torch.searchsorted(keys, q).clamp_max(keys.shape[0] - 1)
    return torch.where(ok & (keys[pos] == q), pos, -1)


@dataclass
class Level:
    """One resolution: sorted int64 coords [N,4] (block, x, y, z), their
    keys, the grid's edge, the submanifold neighbour table [N,27], and the
    strided tables that join it to the next level."""

    coords: torch.Tensor
    keys: torch.Tensor
    shape: int
    subm: torch.Tensor
    order: torch.Tensor            # the sort: coords = given coords[order]
    down: torch.Tensor | None = None   # [N,27] rows of the level above (finer)
    up: torch.Tensor | None = None     # [N,27] rows of the level below (coarser)


def _rows(level_keys, shape, blocks, q):
    """Rows of the voxels at q [M,27,3] in blocks [M] of a level, or -1."""
    m = q.shape[0]
    ok = ((q >= 0) & (q < shape)).all(dim=-1)
    qc = torch.cat([blocks[:, None, None].expand(m, 27, 1), q.clamp_min(0)], dim=-1)
    return _lookup(level_keys, _key(qc.reshape(-1, 4)).reshape(m, 27), ok)


def _level(coords, shape):
    order = torch.argsort(_key(coords))
    coords = coords[order]
    keys = _key(coords)
    subm = _rows(keys, shape, coords[:, 0], coords[:, None, 1:] + _offsets(coords.device) - 1)
    return Level(coords, keys, shape, subm, order)


def build_levels(coords, side, n_levels=4, device="cpu"):
    """The levels of one input on a grid of edge `side`: level 0 its voxels
    (sorted: `order`); each next one the outputs of a 3^3 conv of stride 2
    and padding 1 (o covers 2o-1..2o+1) on a grid of edge (side - 1) // 2 + 1,
    with `down` (the finer row at 2o-1+k) and, on the finer level, `up` (its
    transpose: the coarser row o with 2o-1+k = f)."""
    levels = [_level(torch.as_tensor(coords, dtype=torch.int64, device=device), side)]
    shape = side
    for _ in range(n_levels - 1):
        fine = levels[-1]
        f = fine.coords
        cand = []
        shape = (shape - 1) // 2 + 1
        for corner in range(8):
            bits = torch.tensor([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1],
                                device=f.device)
            o = torch.div(f[:, 1:] - 1 + 2 * bits, 2, rounding_mode="floor")
            ok = ((o >= 0) & (o < shape) & (2 * o - 1 <= f[:, 1:])
                  & (f[:, 1:] <= 2 * o + 1)).all(dim=1)
            cand.append(torch.cat([f[ok, :1], o[ok]], dim=1))
        coarse = _level(torch.unique(torch.cat(cand), dim=0), shape)
        n_c = coarse.coords.shape[0]
        coarse.down = _rows(fine.keys, fine.shape, coarse.coords[:, 0],
                            2 * coarse.coords[:, None, 1:] - 1 + _offsets(f.device))
        up = torch.full((f.shape[0] + 1, 27), -1, dtype=torch.int64, device=f.device)
        rows = torch.arange(n_c, device=f.device)[:, None].expand(n_c, 27)
        cols = torch.arange(27, device=f.device)[None, :].expand(n_c, 27)
        up[torch.where(coarse.down >= 0, coarse.down, f.shape[0]), cols] = rows
        fine.up = up[:-1]
        levels.append(coarse)
    return levels


def _round(x, mode):
    if mode is None:
        return x
    if mode == "tf32":
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    if mode == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if mode == "fp8":
        scale = x.abs().max().clamp_min(1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    raise ValueError(f"unknown rounding mode {mode!r}")


class UNet:
    """The checkpoint's network in eval mode (batch norm by its running
    statistics)."""

    def __init__(self, ckpt, device, mode=None, planes=(8, 16, 32, 64)):
        self.p = {k: v.to(device) for k, v in ckpt.items()}
        self.mode = mode
        self.planes = planes

    def _w(self, path):
        return self.p["params/" + path]

    def _bn(self, x, path):
        mean, var = self.p[f"batch_stats/{path}/mean"], self.p[f"batch_stats/{path}/var"]
        scale, bias = self._w(f"{path}/scale"), self._w(f"{path}/bias")
        return (x - mean) * (torch.rsqrt(var + 1e-5) * scale) + bias

    def _linear(self, x, w):
        return _round(x, self.mode) @ _round(w[0], self.mode)

    def _conv(self, x, table, w):
        """out[i] = sum_k x[table[i, k]] @ w[k] (a zero row where -1)."""
        w2 = _round(w.reshape(-1, w.shape[-1]), self.mode)
        xp = torch.cat([_round(x, self.mode), x.new_zeros(1, x.shape[1])])
        out = []
        for r in range(0, table.shape[0], ROW_CHUNK):
            t = table[r:r + ROW_CHUNK]
            g = xp[torch.where(t >= 0, t, x.shape[0])]
            out.append(g.reshape(t.shape[0], -1) @ w2)
        return torch.cat(out) if out else x.new_zeros(0, w.shape[-1])

    def _res(self, x, table, path):
        ident = x
        if f"params/{path}/identity.0/weight" in self.p:
            ident = self._linear(x, self._w(f"{path}/identity.0/weight"))
        h = torch.relu(self._bn(self._conv(x, table, self._w(f"{path}/sequence.0/weight")),
                                f"{path}/sequence.1"))
        h = self._bn(self._conv(h, table, self._w(f"{path}/sequence.3/weight")),
                     f"{path}/sequence.4")
        return torch.relu(h + ident)

    def _cna(self, x, table, path):
        return torch.relu(self._bn(self._conv(x, table, self._w(f"{path}/0/weight")),
                                   f"{path}/1"))

    def _u(self, levels, x, lvl, path):
        lv = levels[lvl]
        out = self._res(x, lv.subm, f"{path}/Head")
        if lvl + 1 < len(levels):
            nxt = levels[lvl + 1]
            down = self._cna(out, nxt.down, f"{path}/Encode.sequence")
            deep = self._u(levels, down, lvl + 1, f"{path}/U")
            up = self._cna(deep, lv.up, f"{path}/Decode.sequence")
            out = self._res(torch.cat([out, up], dim=1), lv.subm, f"{path}/Tail")
        return out

    def _head(self, x, name):
        h = x
        for i in (0, 3):
            h = torch.relu(self._bn(self._linear(h, self._w(f"{name}/sequence.{i}.weight")),
                                    f"{name}/sequence.{i + 1}"))
        return self._linear(h, self._w(f"{name}/sequence.6.weight"))

    @torch.no_grad()
    def __call__(self, levels, feats):
        """(log radius [N], unit direction [N,3], the direction's norm before
        the normalisation [N], class logits [N,2]) of level 0's rows."""
        x = torch.relu(self._bn(self._linear(feats, self._w("input_conv.sequence/0/weight")),
                                "input_conv.sequence/1"))
        x = self._u(levels, x, 0, "UNet")
        radius = self._head(x, "radius_head")[:, 0]
        d = self._head(x, "direction_head")
        n2 = (d * d).sum(dim=1, keepdim=True)
        d = d * torch.rsqrt(torch.clamp(n2, min=1e-24))
        return radius, d, torch.sqrt(n2[:, 0]), self._head(x, "class_head")
