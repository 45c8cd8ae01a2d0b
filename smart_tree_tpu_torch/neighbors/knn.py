"""Masked fixed-radius K-nearest-neighbours (counterpart of
`smart_tree_tpu/neighbors/knn.py`).

Tiled brute force: squared distances per (source tile, destination chunk) in
the centred form |s|^2 + |d|^2 - 2 s.d, merged into a running selection of
the `k + 8` nearest, then the selected pairs are recomputed exactly, sorted
again and gated by the radius. `radius_count` is the counting variant with a
margin for the cancellation error of that form.

Semantics:
  - the query point itself is a neighbour (distance 0) when src is dst
  - results sorted ascending by distance, equal distances by index
  - neighbours beyond `r` get idx = -1, dist = +inf

Selection never depends on the order `torch.topk` gives to equal values:
each candidate is one int64 key, the bits of its (non-negative) squared
distance above its index, so all keys differ and the smallest `k + 8` keys
are the nearest candidates with the lowest index first among equals. All
arithmetic is fp32; the s.d product has K = 3 and must not run in TF32
(`device.resolve_device` switches it off). On the CPU the roots of the
distances must not be the first parallel call of torch's vector math in the
process (`device.settle_cpu_math`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..device import resolve_device, settle_cpu_math

SRC_TILE = 2048
DST_CHUNK = 16384
# a tile holds at most SRC_TILE x DST_CHUNK pairs: against few dst points (the
# branch tracer asks for the nearest of <= 128 path vertices) the source tile
# grows instead, or every call would be a long loop of tiny tiles
TILE_PAIRS = SRC_TILE * DST_CHUNK
_NO_IDX = (1 << 31) - 1  # index field of an empty selection slot


def _centre(src, dst, dst_valid):
    """src and dst shifted by the centre of the valid dst points' bounding
    box (least |s|^2, the magnitude that cancels), and the box's half
    extent. Invalid rows are left out of the box: a far or non-finite
    padding coordinate would shift every distance."""
    if dst.shape[0] == 0:
        return src, dst, dst.new_zeros(3)
    anchor = dst[torch.argmax(dst_valid.to(torch.uint8))]
    dst_m = torch.where(dst_valid[:, None], dst, anchor[None, :])
    lo, hi = dst_m.min(dim=0).values, dst_m.max(dim=0).values
    centre = (lo + hi) * 0.5
    return src - centre, dst - centre, (hi - lo) * 0.5


def _pair_d2(s, s_norm2, d, d_norm2):
    """[TS, DC] squared distances |s|^2 + |d|^2 - 2 s.d. `d_norm2` is +inf
    at invalid dst rows, which makes their whole column +inf."""
    d2 = torch.mm(s, d.T)
    d2.mul_(-2.0).add_(d_norm2[None, :]).add_(s_norm2[:, None])
    return d2


def _tiles(m: int, src_tile, dst_chunk):
    """Tile sizes for m dst points where the caller names none."""
    dst_chunk = DST_CHUNK if dst_chunk is None else dst_chunk
    if src_tile is None:
        src_tile = max(SRC_TILE, TILE_PAIRS // max(min(m, dst_chunk), 1))
    return src_tile, dst_chunk


def _knn_impl(src, dst, src_valid, dst_valid, r2, k: int, src_tile=None, dst_chunk=None):
    if src.device.type == "cpu":  # the tracer calls in here, past resolve_device
        settle_cpu_math()
    src, dst, _ = _centre(src, dst, dst_valid)
    n, m = src.shape[0], dst.shape[0]
    src_tile, dst_chunk = _tiles(m, src_tile, dst_chunk)
    dev = src.device
    # over-select so exact recomputation can demote selection-error picks
    ksel = k + 8
    inf = float("inf")
    d_norm2 = torch.where(dst_valid, (dst * dst).sum(dim=1), inf)
    inf_bits = torch.tensor(inf, dtype=torch.float32).view(torch.int32).item()
    empty_key = (inf_bits << 32) | _NO_IDX
    cols = torch.arange(m, dtype=torch.int64, device=dev)

    sel = torch.empty((n, ksel), dtype=torch.int64, device=dev)
    for t0 in range(0, n, src_tile):
        s = src[t0 : t0 + src_tile]
        s_norm2 = (s * s).sum(dim=1)
        best = torch.full((s.shape[0], ksel), empty_key, dtype=torch.int64, device=dev)
        for c0 in range(0, m, dst_chunk):
            d2 = _pair_d2(s, s_norm2, dst[c0 : c0 + dst_chunk], d_norm2[c0 : c0 + dst_chunk])
            # clamp, and + 0.0 turns a -0.0 into +0.0: the bits of a
            # non-negative float order like its value
            d2.clamp_min_(0.0).add_(0.0)
            keys = (d2.view(torch.int32).to(torch.int64) << 32) | cols[None, c0 : c0 + dst_chunk]
            if keys.shape[1] > ksel:
                keys = torch.topk(keys, ksel, dim=1, largest=False, sorted=False).values
            best = torch.topk(torch.cat([best, keys], dim=1), ksel, dim=1,
                              largest=False, sorted=True).values
        sel[t0 : t0 + src_tile] = best
    idxs = sel & 0xFFFFFFFF
    sel_d2 = (sel >> 32).to(torch.int32).view(torch.float32)
    ok = (sel_d2 <= r2) & src_valid[:, None] & (idxs != _NO_IDX)
    idxs = torch.where(ok, idxs, -1)

    # The |s|^2 + |d|^2 - 2 s.d form cancels for nearby points (errors of
    # about ulp(|s|^2): sub-mm distances at metre coordinates collapse to
    # 0). Selection only needs ordering, but edge WEIGHTS need accuracy:
    # recompute the ksel selected pairs exactly, sort again (stable, so equal
    # distances stay in index order), keep the best k, gate by the radius.
    diff = src[:, None, :] - dst[idxs.clamp_min(0)]
    d2 = (diff * diff).sum(dim=2)
    d2 = torch.where(idxs >= 0, d2, inf)
    order = torch.sort(d2, dim=1, stable=True).indices[:, :k]
    d2 = torch.gather(d2, 1, order)
    idxs = torch.gather(idxs, 1, order)
    ok = (d2 <= r2) & (idxs >= 0)
    return torch.sqrt(torch.where(ok, d2, inf)), torch.where(ok, idxs, -1)


def _as_inputs(src, dst, src_valid, dst_valid, device):
    if device is None:
        device = src.device if isinstance(src, torch.Tensor) else "cpu"
    dev = resolve_device(device)
    src = torch.as_tensor(src, dtype=torch.float32, device=dev).reshape(-1, 3)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=dev).reshape(-1, 3)
    if src_valid is None:
        src_valid = torch.ones(src.shape[0], dtype=torch.bool, device=dev)
    if dst_valid is None:
        dst_valid = torch.ones(dst.shape[0], dtype=torch.bool, device=dev)
    return (src, dst, torch.as_tensor(src_valid, dtype=torch.bool, device=dev),
            torch.as_tensor(dst_valid, dtype=torch.bool, device=dev))


@torch.no_grad()
def knn(src, dst, k: int, r, src_valid=None, dst_valid=None, device=None,
        src_tile: int | None = None, dst_chunk: int | None = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest dst per src within radius r, on the device of `src` (or
    `device`). The result does not depend on the tile sizes.

    Returns (dists [N,K] float32, euclidean, inf where missing;
             idxs [N,K] int64, -1 where missing), sorted ascending.
    """
    src, dst, src_valid, dst_valid = _as_inputs(src, dst, src_valid, dst_valid, device)
    r2 = torch.as_tensor(r, dtype=torch.float32, device=src.device) ** 2
    if dst.shape[0] == 0:
        return (src.new_full((src.shape[0], k), float("inf")),
                torch.full((src.shape[0], k), -1, dtype=torch.int64, device=src.device))
    return _knn_impl(src, dst, src_valid, dst_valid, r2, k, src_tile, dst_chunk)


def nn(src, dst, r, src_valid=None, dst_valid=None, device=None):
    """Nearest single neighbour."""
    d, i = knn(src, dst, 1, r, src_valid, dst_valid, device)
    return d[:, 0], i[:, 0]


@torch.no_grad()
def radius_count(src, dst, radii, src_valid=None, dst_valid=None, cap: int = 8,
                 device=None, src_tile: int | None = None, dst_chunk: int | None = None):
    """(certain, possible) counts of valid dst within each src's radius,
    saturated at `cap`.

    certain[i] >= t guarantees >= t true neighbours (d < radii[i]);
    possible[i] < t guarantees fewer. Rows where the two straddle t must be
    resolved exactly by the caller: the margin delta2 scales with the
    centred coordinate extent and bounds the cancellation error of the
    |s|^2 + |d|^2 - 2 s.d form (a few ulps of the norm terms, <= 2 E^2 after
    centring; 32 ulps is conservative and still thin next to
    r^2 >= (2 cm)^2 at tree extents)."""
    src, dst, src_valid, dst_valid = _as_inputs(src, dst, src_valid, dst_valid, device)
    dev = src.device
    n, m = src.shape[0], dst.shape[0]
    src_tile, dst_chunk = _tiles(m, src_tile, dst_chunk)
    r2 = torch.as_tensor(radii, dtype=torch.float32, device=dev).reshape(-1) ** 2
    src, dst, half = _centre(src, dst, dst_valid)
    delta2 = torch.clamp_min(32.0 * 1.2e-7 * (half * half).sum(), 1e-7)
    d_norm2 = torch.where(dst_valid, (dst * dst).sum(dim=1), float("inf"))
    lo = torch.zeros(n, dtype=torch.int32, device=dev)
    hi = torch.zeros(n, dtype=torch.int32, device=dev)
    for t0 in range(0, n, src_tile):
        s = src[t0 : t0 + src_tile]
        s_norm2 = (s * s).sum(dim=1)
        r2_lo = (r2[t0 : t0 + src_tile] - delta2)[:, None]
        r2_hi = (r2[t0 : t0 + src_tile] + delta2)[:, None]
        for c0 in range(0, m, dst_chunk):
            d2 = _pair_d2(s, s_norm2, dst[c0 : c0 + dst_chunk], d_norm2[c0 : c0 + dst_chunk])
            lo[t0 : t0 + src_tile] += (d2 < r2_lo).sum(dim=1, dtype=torch.int32)
            hi[t0 : t0 + src_tile] += (d2 < r2_hi).sum(dim=1, dtype=torch.int32)
    lo = torch.where(src_valid, lo.clamp_max(cap), 0)
    hi = torch.where(src_valid, hi.clamp_max(cap), 0)
    return lo, hi
