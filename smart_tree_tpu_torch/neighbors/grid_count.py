"""Cell-sorted fixed-radius neighbour count: the counting query of the
outlier filter (`skeleton/filter.py`). The JAX package answers it with
`smart_tree_tpu/neighbors/knn.py::radius_count` (kept in the port as
`knn.radius_count`): N^2 distances in the |s|^2 + |d|^2 - 2 s.d form over
dense tiles, with a margin that grows with the square of the cloud's extent.
At a forest's extent that margin is wider than the radii, and most rows fall
into the shell the filter must resolve with a brute-force KNN.

Here:
  - the valid, finite dst points are sorted into cubic cells of edge `h`
    from the origin `o` (their minimum corner), one int64 key a cell, z
    fastest: key = (cx * gy + cy) * gz + cz, so the z run of one (x, y)
    column is one contiguous range of the sorted keys;
  - a query of reach R visits on each axis the cells from
    floor((p - R - o) / h) to floor((p + R - o) / h), clamped to the grid
    (in floating point, before any integer conversion), column by column:
    two binary searches a column;
  - distances are differences, d2 = dx*dx + dy*dy + dz*dz with dx = src -
    dst, rounded op by op in that order, so the CUDA kernel
    (csrc/radius_count.cu) reproduces every bit.

The cell edge (`_edge`) is the median reach of the rows that count, not the
largest: one absurd radius (an overflowed exp, bf16 log radii hundreds apart)
would otherwise make one cell of the whole cloud. It is at least the extent
over MAX_CELLS, so that a key fits 63 bits. The edge decides which cells a
query visits, never a count.

The margin. certain = #{d2 < r^2 - m}, possible = #{d2 < r^2 + m}, with
m = REL_ULPS * EPS * r^2 + 2 |r| delta + delta^2 (EPS = 1.2e-7, about
2^-23; delta = CENTRE_ULPS * EPS * M, M the largest coordinate of a valid
point measured from the centre of the valid dst box):
  - d2 above: three subtractions, three products and two sums of
    non-negative terms, each rounded to within 2^-24 of its result, so d2 is
    within 5 * 2^-24 of the exact squared distance of the fp32 inputs,
    relative to that distance; r^2 is one rounded product, 2^-24;
  - the filter resolves its shell with the exact KNN (`knn`), whose fp32
    recompute of a pair rounds by 6 * 2^-24 relative (differences,
    products, sums, the root, the comparison with r), but which first
    centres every coordinate on the valid dst box: each centred coordinate
    rounds by up to 2^-24 M, a difference of two by 2^-23 M an axis,
    sqrt(3) * 2^-23 M in the distance. That error is absolute, not
    relative: it enters as (r + delta)^2 - r^2 = 2 r delta + delta^2;
  - so with 12 * 2^-24 = 6 EPS of relative error on both sides together,
    REL_ULPS = 8 leaves room for the rounding of m itself, and
    CENTRE_ULPS = 4 is twice sqrt(3) * 2^-23 / EPS. A row whose decision
    the count makes then gets the decision the exact KNN would give it,
    and a row the count cannot decide is in the filter's shell.
At the forest scan's extent (M about 25 m) delta is 1.2e-5 m, and at r = 2
cm the margin is 4.8e-7 m^2, where `knn.radius_count`'s is 4.5e-3 m^2.

Thresholds and reach are computed once by torch and handed to the kernel:
an infinite radius (or r^2 past the fp32 range) gets r^2 - m = +inf, not
inf - inf = NaN, and counts every valid point; a NaN radius, an invalid src
row or a non-finite src point gets NaN thresholds and counts nothing, without
a scan. The reach is (|r| + delta)(1 + 2^-18), above sqrt(r^2 + m) with room
for its own rounding, so every point a comparison can count lies in the
visited cells (the cell of a dst point and the bounds of a query's range are
the same monotone function of one fp32 coordinate).

`grid_radius_count` launches the kernel on CUDA tensors and runs
`grid_radius_count_plain` on CPU tensors; nothing else is dispatched.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core import kernels
from .knn import TILE_PAIRS, _as_inputs

EPS = 1.2e-7
REL_ULPS = 8.0
CENTRE_ULPS = 4.0
REACH_SLACK = 2.0 ** -18
MAX_CELLS = 1 << 20


class Grid(NamedTuple):
    """The sorted dst cells and the per-query thresholds of one count."""
    lo2: torch.Tensor        # [N] fp32, certain threshold; NaN: count nothing
    hi2: torch.Tensor        # [N] fp32, possible threshold
    reach: torch.Tensor      # [N] fp32, search radius
    keys: torch.Tensor       # [M'] int64, sorted cell keys of the valid finite dst
    pts: torch.Tensor        # [M', 3] fp32, those points in key order
    origin: torch.Tensor     # [3] fp32
    cell: torch.Tensor       # [] fp32 edge
    dims: Tuple[int, int, int]

    def host(self):
        """(ox, oy, oz, h): the fp32 origin and edge as Python floats."""
        return (*self.origin.tolist(), float(self.cell))


def _cells(x, origin, cell):
    """floor((x - o) / h) in fp32, unclamped, not converted."""
    return torch.floor((x - origin) / cell)


def _edge(reach, counted, extent: float) -> float:
    """The cell edge: the median reach of the `counted` rows, the extent
    when no row counts."""
    return float(reach[counted].median()) if bool(counted.any()) else extent


def build_grid(src, dst, radii, src_valid, dst_valid):
    """The grid and thresholds for fp32 [N,3] src, [M,3] dst, [N] radii and
    bool masks on one device; None when no dst point is valid and finite."""
    dok = dst_valid & torch.isfinite(dst).all(dim=1)
    pts = dst[dok]
    if pts.shape[0] == 0:
        return None
    sok = src_valid & torch.isfinite(src).all(dim=1)
    lo_box, hi_box = pts.min(dim=0).values, pts.max(dim=0).values
    centre = (lo_box + hi_box) * 0.5
    far = (pts - centre).abs().max()
    if bool(sok.any()):
        far = torch.maximum(far, (src[sok] - centre).abs().max())
    delta = CENTRE_ULPS * EPS * far

    r2 = radii * radii
    r_abs = radii.abs()
    m = REL_ULPS * EPS * r2 + (2.0 * r_abs * delta + delta * delta)
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=src.device)
    lo2 = torch.where(sok, torch.where(torch.isinf(r2), r2, r2 - m), nan)
    hi2 = torch.where(sok, r2 + m, nan)
    reach = (r_abs + delta) * (1.0 + REACH_SLACK)

    extent = float((hi_box - lo_box).max())
    counted = (hi2 > 0) & torch.isfinite(reach)
    cell = max(_edge(reach, counted, extent), extent / (MAX_CELLS - 1))
    if not cell > 0.0 or cell == float("inf"):
        cell = 1.0
    h = torch.tensor(cell, dtype=torch.float32, device=src.device)
    dims = tuple(int(g) + 1 for g in _cells(hi_box, lo_box, h).tolist())

    c = _cells(pts, lo_box, h).to(torch.int64)
    key = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
    keys, order = torch.sort(key, stable=True)
    return Grid(lo2, hi2, reach, keys, pts[order].contiguous(), lo_box, h, dims)


def _ranges(src, g: Grid):
    """Per query the first and last cell of each axis, clamped to the grid
    ([N, 3] int64 each, 0 where the row does not scan), and whether it scans:
    thresholds that can count (hi2 > 0, false for NaN) and a range that
    meets the grid."""
    reach = g.reach[:, None]
    a = _cells(src - reach, g.origin, g.cell)
    b = _cells(src + reach, g.origin, g.cell)
    top = torch.tensor([d - 1 for d in g.dims], dtype=torch.float32, device=src.device)
    scan = (g.hi2 > 0) & (b >= 0).all(dim=1) & (a <= top).all(dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=src.device)
    a = torch.where(scan[:, None], torch.maximum(a, zero), zero).to(torch.int64)
    b = torch.where(scan[:, None], torch.minimum(b, top), zero).to(torch.int64)
    return a, b, scan


def _spans(counts: torch.Tensor, limit: int):
    """Consecutive [i0, i1) of `counts` whose sums stay within `limit` (one
    entry at least)."""
    ends = torch.cumsum(counts, 0)
    total = int(ends[-1]) if ends.numel() else 0
    i0, done = 0, 0
    while i0 < counts.shape[0]:
        i1 = int(torch.searchsorted(ends, done + limit, right=True))
        i1 = max(i1, i0 + 1)
        yield i0, i1
        done = int(ends[i1 - 1])
        i0 = i1
        if done >= total:
            break


def _expand(counts: torch.Tensor):
    """(owner, rank): for a ragged expansion of len(counts) entries into
    counts[i] slots each, the entry each slot belongs to and its rank there."""
    owner = torch.repeat_interleave(torch.arange(counts.shape[0], device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    return owner, torch.arange(owner.shape[0], device=counts.device) - first[owner]


def _count_plain(src, g: Grid, cap: int):
    n = src.shape[0]
    dev = src.device
    a, b, scan = _ranges(src, g)
    ny = b[:, 1] - a[:, 1] + 1
    ncols = torch.where(scan, (b[:, 0] - a[:, 0] + 1) * ny, 0)
    certain = torch.zeros(n, dtype=torch.int64, device=dev)
    possible = torch.zeros(n, dtype=torch.int64, device=dev)
    rows = torch.nonzero(scan).squeeze(1)
    gy, gz = g.dims[1], g.dims[2]
    for r0, r1 in _spans(ncols[rows], TILE_PAIRS):
        r = rows[r0:r1]
        owner, j = _expand(ncols[r])
        q = r[owner]                                   # the query of each column
        cx = a[q, 0] + torch.div(j, ny[q], rounding_mode="floor")
        cy = a[q, 1] + j % ny[q]
        base = (cx * gy + cy) * gz
        start = torch.searchsorted(g.keys, base + a[q, 2])
        length = torch.searchsorted(g.keys, base + b[q, 2], right=True) - start
        for c0, c1 in _spans(length, TILE_PAIRS):
            run, k = _expand(length[c0:c1])
            qq = q[c0:c1][run]
            d = src[qq] - g.pts[start[c0:c1][run] + k]
            dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
            d2 = dx * dx + dy * dy + dz * dz
            certain.index_add_(0, qq, (d2 < g.lo2[qq]).to(torch.int64))
            possible.index_add_(0, qq, (d2 < g.hi2[qq]).to(torch.int64))
    return certain.clamp_max(cap).to(torch.int32), possible.clamp_max(cap).to(torch.int32)


def _inputs(src, dst, radii, src_valid, dst_valid, cap, device):
    if cap < 1:
        raise ValueError(f"cap must be at least 1 (got {cap})")
    src, dst, src_valid, dst_valid = _as_inputs(src, dst, src_valid, dst_valid, device)
    radii = torch.as_tensor(radii, dtype=torch.float32, device=src.device).reshape(-1)
    if radii.shape[0] != src.shape[0]:
        raise ValueError(f"{radii.shape[0]} radii for {src.shape[0]} src points")
    return src.contiguous(), dst.contiguous(), radii.contiguous(), src_valid, dst_valid


def _zeros(n, dev):
    z = torch.zeros(n, dtype=torch.int32, device=dev)
    return z, z.clone()


@torch.no_grad()
def grid_radius_count_plain(src, dst, radii, src_valid=None, dst_valid=None, cap: int = 8,
                            device=None):
    """Plain PyTorch version of `grid_radius_count`, on any device: each
    query's candidates expanded ragged (one searchsorted pair a column, then
    repeat_interleave), at most `knn.TILE_PAIRS` columns and pairs a chunk,
    counted with index_add_ and saturated at `cap`."""
    src, dst, radii, src_valid, dst_valid = _inputs(src, dst, radii, src_valid, dst_valid,
                                                    cap, device)
    g = build_grid(src, dst, radii, src_valid, dst_valid)
    if g is None or src.shape[0] == 0:
        return _zeros(src.shape[0], src.device)
    return _count_plain(src, g, cap)


def _query_order(src, g: Grid):
    """The queries in the order of their own (clamped) cells: neighbouring
    threads of the kernel walk neighbouring cells."""
    top = torch.tensor([d - 1 for d in g.dims], dtype=torch.float32, device=src.device)
    c = _cells(src, g.origin, g.cell)
    zero = torch.zeros((), dtype=torch.float32, device=src.device)
    c = torch.where(torch.isfinite(c), torch.minimum(torch.maximum(c, zero), top), zero)
    c = c.to(torch.int64)
    key = (c[:, 0] * g.dims[1] + c[:, 1]) * g.dims[2] + c[:, 2]
    return torch.argsort(key, stable=True).to(torch.int32)


def _launch(src, order, g: Grid, cap: int, certain, possible) -> None:
    """One launch of the CUDA kernel (counts nothing)."""
    ox, oy, oz, h = g.host()
    rc = kernels.load().st_radius_count(
        src.data_ptr(), src.shape[0], order.data_ptr(), g.lo2.data_ptr(), g.hi2.data_ptr(),
        g.reach.data_ptr(), g.keys.data_ptr(), g.pts.data_ptr(), g.keys.shape[0],
        ox, oy, oz, h, *g.dims, cap, certain.data_ptr(), possible.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    kernels.check(rc, "st_radius_count")


@torch.no_grad()
def grid_radius_count(src, dst, radii, src_valid=None, dst_valid=None, cap: int = 8,
                      device=None):
    """(certain, possible) counts of valid dst within each src's radius,
    int32, saturated at `cap`, zero at invalid src: the contract of
    `knn.radius_count`, with the margin of this module's docstring.

    certain[i] >= t guarantees >= t neighbours with d < radii[i] in every
    fp32 evaluation the filter makes; possible[i] < t guarantees fewer. On
    CUDA tensors it launches csrc/radius_count.cu (and raises if the launch
    fails); on CPU tensors it runs `grid_radius_count_plain`."""
    src, dst, radii, src_valid, dst_valid = _inputs(src, dst, radii, src_valid, dst_valid,
                                                    cap, device)
    if src.device.type == "cpu":
        return grid_radius_count_plain(src, dst, radii, src_valid, dst_valid, cap)
    if src.device.type != "cuda":
        raise ValueError(f"grid_radius_count runs on cuda or cpu, not {src.device}")
    n = src.shape[0]
    if n >= 1 << 31 or dst.shape[0] >= 1 << 31:
        raise ValueError("grid_radius_count takes fewer than 2^31 src and dst points")
    g = build_grid(src, dst, radii, src_valid, dst_valid)
    if g is None or n == 0:
        return _zeros(n, src.device)
    certain = torch.empty(n, dtype=torch.int32, device=src.device)
    possible = torch.empty(n, dtype=torch.int32, device=src.device)
    _launch(src, _query_order(src, g), g, cap, certain, possible)
    grid_radius_count.launches += 1
    return certain, possible


grid_radius_count.launches = 0
