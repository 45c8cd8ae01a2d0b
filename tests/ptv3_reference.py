"""Plain reference: Point Transformer V3 in float32 PyTorch, one tile block
at a time.

Written from the published model (Wu et al., "Point Transformer V3:
Simpler, Faster, Stronger", CVPR 2024, arXiv:2312.10035; Pointcept's
`point_transformer_v3m1_base.py` with `enable_flash=True`) and the
checkpoint's own arrays: no kernel, plan, cache or batching of the program.
It imports nothing but numpy and torch. Every neighbour is found by a binary
search over the level's sorted voxel keys; every conv is a gather of the
kernel's neighbours (a zero row where there is none) times the [K^3 * Cin,
Cout] weight; pooling is `torch.unique` over coords >> 1; attention is the
explicit softmax(Q K^T * head_dim^-1/2) V of each patch. TF32 is off.

The model, on the voxels of one block (coords [n, 3] on its grid, input
features [n, 3]):

  stem     submanifold 5^3 conv (no bias) -> BatchNorm (eps 1e-3) -> GELU
  encoder  stage s > 0: pooling (Linear -> max over each parent cell
           coords >> 1 -> BatchNorm -> GELU), then its blocks
  decoder  stage s = 3 .. 0: unpooling (Linear+BN+GELU of the coarser
           level, taken at each voxel's parent, plus Linear+BN+GELU of the
           encoder's output at this level), then its blocks
  block    x += LayerNorm(Linear(SubMConv3(x) + bias)); x += Proj(Attn(
           LayerNorm(x))); x += Linear(GELU(Linear(LayerNorm(x))))
  heads    SmartTree's: (linear -> BatchNorm (eps 1e-5) -> ReLU) twice, then
           a linear, for the log radius, the direction and the class logits

Attention in order `ORDERS[i % 4]` for block i of a stage: the voxels
sorted by their code under it; a block of at most `patch` voxels is one
patch; a longer one is padded to a multiple of `patch` by repeating, after
its last voxel, the voxels one patch before (Pointcept's
`get_padding_and_inverse`), and each voxel takes its output from its own
first position.

Codes (a plain per-bit loop): the z-order code puts bit i of x, y, z at
bits 3i+2, 3i+1, 3i; the Hilbert code is Pointcept's `hilbert.encode`
(bits taken most significant first, the lower bits of axis 0 inverted
where an axis's bit is set and exchanged with that axis's where it is
not, the bits interleaved axis 0 first, then read as a Gray code); the
`-trans` orders swap x and y first.

Departures from Pointcept:
  - the orders are cycled in a fixed order (Pointcept shuffles the four on
    every forward, in eval too);
  - the serialization depth is the bits of the block's grid edge (9 at an
    edge of 481), one fewer a pooling, where Pointcept takes the bits of the
    batch's largest coordinate;
  - the inputs are the voxel's xyz alone, encoded as SmartTree's;
  - SmartTree's three heads on the decoder's 64 channels replace the
    segmentation head;
  - the voxel is 0.01 m.

`mode` rounds the operands of every product (the convs, the linears, and
Q, K, the softmax's weights and V) as `reference/unet.py::_round` does:
"tf32", "bf16", or "fp8" (e4m3, one scale a tensor); the accumulation, the
norms, the softmax and GELU stay float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
ROW_CHUNK = 1 << 15
ATTN_ELEMENTS = 1 << 26     # score elements computed at once


def load_checkpoint(path):
    """{npz key: float32 tensor} of a checkpoint."""
    with np.load(path) as z:
        return {k: torch.from_numpy(np.asarray(z[k], np.float32)) for k in z.files}


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


def z_code(c, depth):
    """z-order codes of int64 coords [n, 3] at `depth` bits an axis."""
    code = torch.zeros_like(c[:, 0])
    for i in range(depth):
        for axis, shift in ((0, 2), (1, 1), (2, 0)):
            code |= ((c[:, axis] >> i) & 1) << (3 * i + shift)
    return code


def hilbert_code(c, depth):
    """Hilbert codes of int64 coords [n, 3] at `depth` bits an axis."""
    bits = [[(c[:, a] >> (depth - 1 - b)) & 1 for b in range(depth)] for a in range(3)]
    for b in range(depth):
        for a in range(3):
            on = bits[a][b]
            for lo in range(b + 1, depth):
                bits[0][lo] = bits[0][lo] ^ on
                swap = (1 - on) & (bits[0][lo] ^ bits[a][lo])
                bits[a][lo] = bits[a][lo] ^ swap
                bits[0][lo] = bits[0][lo] ^ swap
    code, acc = torch.zeros_like(c[:, 0]), torch.zeros_like(c[:, 0])
    for k, bit in enumerate(bits[a][b] for b in range(depth) for a in range(3)):
        acc = acc ^ bit
        code |= acc << (3 * depth - 1 - k)
    return code


def order_code(c, depth, name):
    if name.endswith("-trans"):
        c = c[:, [1, 0, 2]]
    return hilbert_code(c, depth) if name.startswith("hilbert") else z_code(c, depth)


def neighbour_table(c, kernel):
    """[n, kernel^3] rows of each voxel's neighbour at offsets (dx, dy, dz)
    from -(kernel // 2), dx slowest, or -1."""
    h = kernel // 2
    span = int(c.max()) + 2 * h + 1 if len(c) else 1
    key = ((c[:, 0] + h) * span + (c[:, 1] + h)) * span + (c[:, 2] + h)
    skeys, order = torch.sort(key)
    r = torch.arange(-h, h + 1, device=c.device)
    off = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    q = c[:, None, :] + off[None]
    qk = ((q[..., 0] + h) * span + (q[..., 1] + h)) * span + (q[..., 2] + h)
    pos = torch.searchsorted(skeys, qk).clamp_max(len(skeys) - 1)
    return torch.where(skeys[pos] == qk, order[pos], -1)


class PTv3:
    """The checkpoint's network in eval mode (BatchNorm by its running
    statistics)."""

    def __init__(self, ckpt, device="cpu", mode=None):
        self.p = {k: v.to(device) for k, v in ckpt.items()}
        self.mode = mode
        self.head_dim = int(self.p["config/head_dim"])
        self.patch = int(self.p["config/patch_size"])

        def stages(part):
            out = []
            while f"params/{part}/{len(out)}/blocks/0/norm1/scale" in self.p:
                s = len(out)
                out.append(sum(1 for k in self.p if k.startswith(f"params/{part}/{s}/blocks/")
                               and k.endswith("/norm1/scale")))
            return out

        self.enc_depths, self.dec_depths = stages("enc"), stages("dec")

    def _w(self, path):
        return self.p["params/" + path]

    def _bn(self, x, path, eps):
        mean, var = self.p[f"batch_stats/{path}/mean"], self.p[f"batch_stats/{path}/var"]
        return (x - mean) * (torch.rsqrt(var + eps) * self._w(f"{path}/scale")) \
            + self._w(f"{path}/bias")

    def _ln(self, x, path):
        return F.layer_norm(x, (x.shape[1],), self._w(f"{path}/scale"), self._w(f"{path}/bias"),
                            1e-5)

    def _linear(self, x, path):
        return _round(x, self.mode) @ _round(self._w(f"{path}/weight"), self.mode) \
            + self._w(f"{path}/bias")

    def _conv(self, x, table, w):
        """out[i] = sum_k x[table[i, k]] @ w[k] (a zero row where -1)."""
        w2 = _round(w.reshape(-1, w.shape[-1]), self.mode)
        xp = torch.cat([_round(x, self.mode), x.new_zeros(1, x.shape[1])])
        out = [xp[torch.where(t >= 0, t, x.shape[0])].reshape(t.shape[0], -1) @ w2
               for t in table.split(ROW_CHUNK)]
        return torch.cat(out)

    def _lna(self, x, path):
        return F.gelu(self._bn(self._linear(x, f"{path}/linear"), f"{path}/norm", 1e-3))

    def _attention(self, x, order, path):
        n, c = x.shape
        heads, d, k = c // self.head_dim, self.head_dim, self.patch
        qkv = self._linear(x, f"{path}/qkv")
        if n <= k:
            pos = torch.arange(n, device=x.device)[None]
        else:
            j = torch.arange(-(-n // k) * k, device=x.device)
            pos = torch.where(j < n, j, j - k).reshape(-1, k)
        t = qkv[order[pos]].reshape(pos.shape[0], pos.shape[1], 3, heads, d)
        q, kk, v = (_round(u, self.mode) for u in t.permute(2, 0, 3, 1, 4))
        out = []
        step = max(1, ATTN_ELEMENTS // (heads * pos.shape[1] ** 2))
        for i in range(0, pos.shape[0], step):
            s = q[i:i + step] @ kk[i:i + step].transpose(-1, -2) * d ** -0.5
            a = _round(torch.softmax(s, dim=-1), self.mode)
            out.append(a @ v[i:i + step])
        o = torch.cat(out).transpose(1, 2).reshape(-1, c)
        y = torch.empty_like(x)
        y[order] = o[:n]
        return self._linear(y, f"{path}/proj")

    def _block(self, x, table, order, path):
        h = self._conv(x, table, self._w(f"{path}/cpe/conv/weight")) \
            + self._w(f"{path}/cpe/conv/bias")
        x = x + self._ln(self._linear(h, f"{path}/cpe/linear"), f"{path}/cpe/norm")
        x = x + self._attention(self._ln(x, f"{path}/norm1"), order, f"{path}/attn")
        h = F.gelu(self._linear(self._ln(x, f"{path}/norm2"), f"{path}/mlp/fc1"))
        return x + self._linear(h, f"{path}/mlp/fc2")

    def _stage(self, x, tables, orders, part, s, depth):
        for i in range(depth):
            x = self._block(x, tables[s], orders[s][i % len(ORDERS)], f"{part}/{s}/blocks/{i}")
        return x

    def _head(self, x, name):
        h = x
        for i in (0, 3):
            h = _round(h, self.mode) @ _round(self._w(f"{name}/sequence.{i}.weight")[0], self.mode)
            h = torch.relu(self._bn(h, f"{name}/sequence.{i + 1}", 1e-5))
        return _round(h, self.mode) @ _round(self._w(f"{name}/sequence.6.weight")[0], self.mode)

    @torch.no_grad()
    def __call__(self, coords, feats, depth):
        """(log radius [n], unit direction [n, 3], the direction's norm before
        normalising [n], class logits [n, 2]) of one block's voxels: int
        coords [n, 3] on a grid of 2**depth an axis, features [n, 3]."""
        c = torch.as_tensor(coords, dtype=torch.int64, device=feats.device)
        levels, parents = [c], []
        for _ in range(len(self.enc_depths) - 1):
            up, inv = torch.unique(levels[-1] >> 1, dim=0, return_inverse=True)
            levels.append(up)
            parents.append(inv)
        tables = [neighbour_table(lv, 3) for lv in levels]
        orders = [[torch.argsort(order_code(lv, depth - i, name)) for name in ORDERS]
                  for i, lv in enumerate(levels)]
        stem = self._conv(feats, neighbour_table(c, 5), self._w("embedding/conv/weight"))
        x = F.gelu(self._bn(stem, "embedding/norm", 1e-3))
        skips = []
        for s, depth_s in enumerate(self.enc_depths):
            if s:
                h = self._linear(x, f"enc/{s}/down/linear")
                pooled = h.new_zeros(len(levels[s]), h.shape[1]).scatter_reduce(
                    0, parents[s - 1][:, None].expand_as(h), h, "amax", include_self=False)
                x = F.gelu(self._bn(pooled, f"enc/{s}/down/norm", 1e-3))
            x = self._stage(x, tables, orders, "enc", s, depth_s)
            skips.append(x)
        for s in reversed(range(len(self.dec_depths))):
            x = self._lna(skips[s], f"dec/{s}/up/skip") \
                + self._lna(x, f"dec/{s}/up/proj")[parents[s]]
            x = self._stage(x, tables, orders, "dec", s, self.dec_depths[s])
        radius = self._head(x, "radius_head")[:, 0]
        d = self._head(x, "direction_head")
        n2 = (d * d).sum(dim=1, keepdim=True)
        d = d * torch.rsqrt(torch.clamp(n2, min=1e-24))
        return radius, d, torch.sqrt(n2[:, 0]), self._head(x, "class_head")


def forward_blocks(net, coords, feats, side):
    """The heads of every voxel of several blocks, one block at a time:
    coords [M, 4] (block, x, y, z) of a grid of edge `side`, feats [M, 3];
    rows as given."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    depth = int(side - 1).bit_length()
    coords = torch.as_tensor(np.asarray(coords), dtype=torch.int64)
    out = [None] * 4
    parts = []
    for b in torch.unique(coords[:, 0]).tolist():
        rows = torch.nonzero(coords[:, 0] == b)[:, 0]
        heads = net(coords[rows, 1:].to(feats.device), feats[rows.to(feats.device)], depth)
        parts.append((rows, [h.float().cpu() for h in heads]))
    for i in range(4):
        width = parts[0][1][i].shape[1:] if parts else ()
        out[i] = torch.zeros((len(coords),) + tuple(width))
        for rows, heads in parts:
            out[i][rows] = heads[i]
    return tuple(t.numpy() for t in out)
