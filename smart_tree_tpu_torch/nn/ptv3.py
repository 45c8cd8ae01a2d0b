"""Point Transformer V3 (Wu et al., "Point Transformer V3: Simpler, Faster,
Stronger", CVPR 2024; Pointcept's `point_transformer_v3m1_base.py`) over
the port's sparse voxel batches, ending in SmartTree's three heads.

  stem      a submanifold K^3 conv (no bias) -> BatchNorm -> GELU
  encoder   stage s > 0 opens with grid pooling; then its blocks
  decoder   from the deepest level up: unpooling, then its blocks
  heads     SmartTree's SparseFC heads (nn/blocks.py) on level 0

A block, pre-norm (drop-path is the identity in inference):

  x = x + LayerNorm(Linear(SubMConv3(x) + bias))          (the CPE)
  x = x + Proj(PatchAttention(LayerNorm(x)))
  x = x + Linear(GELU(Linear(LayerNorm(x))))              (hidden mlp_ratio * C)

Patch attention runs in the order `orders[i % 4]` (block i of its stage)
over the plan's patches (core/serialize.py): softmax(Q K^T / sqrt(d)) V per
patch and head, heads `head_dim` wide, through
`torch.nn.functional.scaled_dot_product_attention` (the full patches in one
call; the short items in another, their padding slots masked; cuDNN's
kernel left out, SDPA_BACKENDS). Pooling is
Linear, then the max over each parent's children, then BatchNorm and GELU;
unpooling adds Linear+BN+GELU of the coarse level, gathered to the children,
to Linear+BN+GELU of the skip. BatchNorm eps is 1e-3 (Pointcept's), the
heads' 1e-5 (SmartTree's).

Precision (`ConvConfig.precision`): every product (convs, linears and the
attention's two) takes operands in that precision with float32
accumulation; the residual stream, LayerNorm, BatchNorm, GELU and the
softmax statistics are float32. The model is inference-only (eval mode):
the trainer builds SmartTree.

Module names give the state_dict keys of its checkpoints (nn/convert.py):
`embedding.conv.weight` [K^3, Cin, C], `enc.<s>.down.linear.weight` [Cin,
Cout], `enc.<s>.blocks.<i>.attn.qkv.weight` [C, 3C], ...; linear weights
[Cin, Cout] as the port's convs. A checkpoint also holds
`config/head_dim` and `config/patch_size`, which its shapes cannot say.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..core.memory import estimate_serial_hbm, largest_pow2
from ..core.plan import SerialLevelPlan, SerialPlan, build_serial_plan
from ..core.serialize import ORDERS
from ..core.sparse_ops import ConvConfig, operand
from ..core.sparse_tensor import SparseVoxelTensor
from ..utils.trace import span
from .blocks import SparseConv, SparseFC
from .norm import MaskedBatchNorm

BN_EPS = 1e-3
# the attention kernels a patch may take: FlashAttention-2 (no mask), the
# memory-efficient kernel (the short items' mask) and the plain product.
# Not cuDNN's: on the H100 it builds a graph for every new number of
# patches, which left the card idle 4.19 s over two tree clouds
SDPA_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self._rounded = None    # (key, the weight as a product's operand)

    def _operand(self, precision: str) -> torch.Tensor:
        """The weight rounded to `precision` (sparse_ops.linear's rule), kept
        while the weight, its place and the precision stay the same, so that
        a forward queues no rounding of weights. A weight that autograd
        tracks is rounded afresh."""
        w = self.weight
        if torch.is_grad_enabled() and w.requires_grad:
            return operand(w, precision)
        key = (precision, w.device, w.data_ptr(), w._version)
        if self._rounded is None or self._rounded[0] != key:
            self._rounded = (key, operand(w, precision))
        return self._rounded[1]

    def forward(self, x, cfg: ConvConfig):
        return torch.addmm(self.bias, operand(x, cfg.precision), self._operand(cfg.precision))


class LayerNorm(nn.Module):
    """LayerNorm over channels in float32, parameters `scale` and `bias`."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[1],), self.scale, self.bias, self.eps)


class BiasedConv(SparseConv):
    def __init__(self, cin: int, cout: int, kernel_volume: int = 27):
        super().__init__(cin, cout, kernel_volume)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, feats, rulebook=None, cfg: ConvConfig = ConvConfig()):
        return super().forward(feats, rulebook, cfg) + self.bias


class LinearNormAct(nn.Module):
    """Linear -> BatchNorm -> GELU (pooling's and unpooling's projections)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear = Linear(cin, cout)
        self.norm = MaskedBatchNorm(cout, eps=BN_EPS)

    def forward(self, x, cfg):
        return F.gelu(self.norm(self.linear(x, cfg), None))


class PatchAttention(nn.Module):
    def __init__(self, c: int, head_dim: int):
        super().__init__()
        self.heads, self.head_dim = c // head_dim, head_dim
        self.qkv = Linear(c, 3 * c)
        self.proj = Linear(c, c)

    def _sdpa(self, t, mask):
        """t [patches, rows, 3, heads, head_dim] -> [patches * rows, C]."""
        q, k, v = t.permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=self.head_dim ** -0.5)
        return o.transpose(1, 2).reshape(-1, self.heads * self.head_dim)

    def forward(self, h, lv: SerialLevelPlan, order: int, cfg: ConvConfig):
        with span(None, "infer.attention"):
            lay = lv.layout
            t = self.qkv(h, cfg)[lv.gather[order]]
            t = t.to(torch.bfloat16 if cfg.precision == "bfloat16" else torch.float32)
            t = t.view(-1, 3, self.heads, self.head_dim)
            n_full = lay.n_full * lay.patch
            out = []
            if lay.n_full:
                out.append(self._sdpa(t[:n_full].view(lay.n_full, lay.patch, *t.shape[1:]),
                                      None))
            if lay.n_short:
                out.append(self._sdpa(t[n_full:].view(lay.n_short, lay.short_len, *t.shape[1:]),
                                      lay.short_mask[:, None, None, :]))
            y = (out[0] if len(out) == 1 else torch.cat(out)).float()[lv.scatter[order]]
            return self.proj(y, cfg)


class Block(nn.Module):
    def __init__(self, c: int, head_dim: int, mlp_ratio: int):
        super().__init__()
        self.cpe = nn.ModuleDict({"conv": BiasedConv(c, c, 27), "linear": Linear(c, c),
                                  "norm": LayerNorm(c)})
        self.norm1 = LayerNorm(c)
        self.attn = PatchAttention(c, head_dim)
        self.norm2 = LayerNorm(c)
        self.mlp = nn.ModuleDict({"fc1": Linear(c, mlp_ratio * c),
                                  "fc2": Linear(mlp_ratio * c, c)})

    def forward(self, x, lv: SerialLevelPlan, order: int, cfg: ConvConfig):
        cpe = self.cpe
        x = x + cpe["norm"](cpe["linear"](cpe["conv"](x, lv.subm_rb, cfg), cfg))
        x = x + self.attn(self.norm1(x), lv, order, cfg)
        h = F.gelu(self.mlp["fc1"](self.norm2(x), cfg))
        return x + self.mlp["fc2"](h, cfg)


class Stage(nn.Module):
    """One level's blocks, block i in order i % len(orders)."""

    def __init__(self, c: int, depth: int, head_dim: int, mlp_ratio: int):
        super().__init__()
        self.blocks = nn.ModuleList(Block(c, head_dim, mlp_ratio) for _ in range(depth))

    def run(self, x, lv, cfg, n_orders):
        for i, blk in enumerate(self.blocks):
            x = blk(x, lv, i % n_orders, cfg)
        return x


class Pooling(LinearNormAct):
    """Linear, the max over each parent's children (`parent` [N] the
    parent row of each voxel), BatchNorm, GELU."""

    def forward(self, x, parent, n_parents: int, cfg):
        h = self.linear(x, cfg)
        h = h.new_zeros((n_parents, h.shape[1])).scatter_reduce_(
            0, parent[:, None].expand_as(h), h, "amax", include_self=False)
        return F.gelu(self.norm(h, None))


class Unpooling(nn.Module):
    def __init__(self, cin: int, cskip: int, cout: int):
        super().__init__()
        self.proj = LinearNormAct(cin, cout)
        self.skip = LinearNormAct(cskip, cout)

    def forward(self, x, skip, parent, cfg):
        return self.skip(skip, cfg) + self.proj(x, cfg)[parent]


class PTv3(nn.Module):
    def __init__(
        self,
        input_channels: int = 3,
        stem_kernel: int = 5,
        enc_channels: Sequence[int] = (32, 64, 128, 256, 512),
        enc_depths: Sequence[int] = (2, 2, 2, 6, 2),
        dec_channels: Sequence[int] = (64, 64, 128, 256),
        dec_depths: Sequence[int] = (2, 2, 2, 2),
        head_dim: int = 16,
        patch_size: int = 1024,
        mlp_ratio: int = 4,
        radius_fc_planes: Sequence[int] = (64, 8, 4, 1),
        direction_fc_planes: Sequence[int] = (64, 8, 4, 3),
        class_fc_planes: Sequence[int] = (64, 8, 4, 2),
        orders: Sequence[str] = ORDERS,
    ):
        super().__init__()
        self.input_channels = int(input_channels)
        self.stem_kernel = int(stem_kernel)
        self.enc_channels = tuple(int(c) for c in enc_channels)
        self.dec_channels = tuple(int(c) for c in dec_channels)
        self.head_dim, self.patch_size = int(head_dim), int(patch_size)
        self.mlp_ratio = int(mlp_ratio)
        self.orders = tuple(orders)
        if len(self.dec_channels) != len(self.enc_channels) - 1:
            raise ValueError("the decoder has one stage fewer than the encoder")
        self.embedding = nn.ModuleDict({
            "conv": SparseConv(input_channels, self.enc_channels[0], self.stem_kernel ** 3),
            "norm": MaskedBatchNorm(self.enc_channels[0], eps=BN_EPS)})
        self.enc = nn.ModuleList()
        for s, (c, d) in enumerate(zip(self.enc_channels, enc_depths)):
            stage = Stage(c, d, head_dim, mlp_ratio)
            if s:
                stage.down = Pooling(self.enc_channels[s - 1], c)
            self.enc.append(stage)
        self.dec = nn.ModuleList()
        coarse = self.dec_channels[1:] + self.enc_channels[-1:]
        for s, (c, d) in enumerate(zip(self.dec_channels, dec_depths)):
            stage = Stage(c, d, head_dim, mlp_ratio)
            stage.up = Unpooling(coarse[s], self.enc_channels[s], c)
            self.dec.append(stage)
        self.radius_head = SparseFC(radius_fc_planes)
        self.direction_head = SparseFC(direction_fc_planes)
        self.class_head = SparseFC(class_fc_planes)

    def forward(self, plan: SerialPlan, feats: torch.Tensor,
                cfg: ConvConfig = ConvConfig()) -> Dict[str, torch.Tensor]:
        with sdpa_kernel(SDPA_BACKENDS):
            lv = plan.levels
            emb = self.embedding
            x = F.gelu(emb["norm"](emb["conv"](feats, lv[0].stem_rb, cfg), None))
            skips = []
            n_orders = len(self.orders)
            for s, stage in enumerate(self.enc):
                if s:
                    x = stage.down(x, lv[s - 1].parent, lv[s].keys.shape[0], cfg)
                x = stage.run(x, lv[s], cfg, n_orders)
                skips.append(x)
            for s in reversed(range(len(self.dec))):
                stage = self.dec[s]
                x = stage.up(x, skips[s], lv[s].parent, cfg)
                x = stage.run(x, lv[s], cfg, n_orders)
            mask = lv[0].active
            radius = self.radius_head(x, mask, cfg)
            direction_raw = self.direction_head(x, mask, cfg)
            n2 = (direction_raw * direction_raw).sum(dim=1, keepdim=True)
            direction = direction_raw * torch.rsqrt(torch.clamp(n2, min=1e-24))
            return {"radius": radius, "direction": direction, "direction_raw": direction_raw,
                    "class_l": self.class_head(x, mask, cfg)}

    def build_plan(self, x: SparseVoxelTensor, level_capacity_factor: float | None = None,
                   stats: dict | None = None) -> SerialPlan:
        """The exact serialized plan of `x` (core/plan.py::build_serial_plan).
        `stats` gets the plan's span. The plan's `counters` are what the
        forward over it attends: `attn_patches` and `attn_pad_rows`, each
        level's patches and padded rows times the blocks at that level."""
        if level_capacity_factor is not None:
            raise ValueError("a PTv3 plan is exact: level_capacity_factor must be None")
        plan = build_serial_plan(x, len(self.enc_channels), self.patch_size, self.stem_kernel,
                                 self.orders, stats)
        blocks = [len(e.blocks) + (len(self.dec[s].blocks) if s < len(self.dec) else 0)
                  for s, e in enumerate(self.enc)]
        return replace(plan, counters={
            "attn_patches": sum(b * lv.layout.patches for b, lv in zip(blocks, plan.levels)),
            "attn_pad_rows": sum(b * lv.layout.pad_rows for b, lv in zip(blocks, plan.levels))})

    def _widths(self):
        return tuple(max(e, d) for e, d in zip(self.enc_channels,
                                                self.dec_channels + (0,)))

    def forward_peak(self, level_rows: Sequence[int], in_flight: int = 1, **terms) -> int:
        """The footprint model's peak bytes of a plan of `level_rows`
        (core/memory.py::estimate_serial_hbm)."""
        return estimate_serial_hbm(level_rows, self._widths(), self.mlp_ratio,
                                   self.stem_kernel ** 3, self.input_channels, self.patch_size,
                                   in_flight=in_flight, **terms)["peak"]

    def max_batch_capacity(self, budget_bytes: int, in_flight: int = 1, **terms) -> int:
        """The largest pow2 batch whose modelled peak fits the budget, each
        level half the one above."""
        levels = range(len(self.enc_channels))
        return largest_pow2(lambda cap: self.forward_peak(
            [max(cap >> lvl, 1) for lvl in levels], in_flight, **terms) <= budget_bytes)
