"""Grid-bucketed fixed-radius KNN for large clouds (counterpart of
`smart_tree_tpu/neighbors/grid.py`), where the tiled brute force of
`neighbors/knn.py` is O(N*M).

  - dst points are bucketed into cells of edge `r` (the query radius): every
    neighbour within r lies in the 27 surrounding cells;
  - cell coordinates are packed into sorted keys, z fastest, so the three
    cells (dx, dy, -1..1) are CONSECUTIVE keys and their points form ONE
    contiguous range of the sorted array: 9 searchsorteds and 9 windows of
    3 * cell_cap candidates replace 27 cell probes;
  - distances are computed on coordinate differences in fp32 (small
    magnitudes, none of the cancellation of |s|^2 + |d|^2 - 2 s.d);
  - queries go through a Python loop over chunks sized so that one chunk's
    candidates stay at `knn.TILE_PAIRS` pairs.

Keys are int64 tensors holding the reference's uint32 values (torch has no
unsigned arithmetic worth the name): 0xFFFFFFFF marks an invalid or
out-of-grid point and sorts last.

Exactness is guaranteed when no cell holds more than `cell_cap` points. The
maximum occupancy is measured on every call; past the cap the query reruns
once at the next power of two (or raises, see `grid_knn`).

Equal distances come out in candidate order (neighbour column, then position
in the sorted array), not in index order as `knn` gives them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .knn import TILE_PAIRS, _as_inputs

_INVALID = 0xFFFFFFFF
# the 9 (dx, dy) neighbour columns; each one's dz = -1..+1 cells are consecutive keys
_OFFSETS = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


def _masked_extent(pts, valid):
    """(min, max) over valid rows. Falls back to the first valid row (or row
    0) when the mask is empty."""
    anchor = pts[torch.argmax(valid.to(torch.uint8))]
    m = torch.where(valid[:, None], pts, anchor[None, :])
    return m.min(dim=0).values, m.max(dim=0).values


def _pack_cells(c: torch.Tensor, bits: Tuple[int, int, int], valid) -> torch.Tensor:
    """int64 keys ((x << by) | y) << bz | z of int64 cell coordinates [N,3];
    `_INVALID` outside the grid or where `valid` is false."""
    bx, by, bz = bits
    ok = (
        (c[:, 0] >= 0) & (c[:, 0] < (1 << bx))
        & (c[:, 1] >= 0) & (c[:, 1] < (1 << by))
        & (c[:, 2] >= 0) & (c[:, 2] < (1 << bz))
    )
    if valid is not None:
        ok = ok & valid
    key = (((c[:, 0] << by) | c[:, 1]) << bz) | c[:, 2]
    return torch.where(ok, key, _INVALID)


def _cells(pts, origin, r: float):
    return torch.floor((pts - origin[None, :]) / r).to(torch.int64)


def _grid_knn_impl(src, dst, src_valid, dst_valid, r: float, origin, k: int,
                   bits: Tuple[int, int, int], cell_cap: int):
    n, m = src.shape[0], dst.shape[0]
    dev = src.device
    inf = float("inf")
    r2 = float(np.float32(r) * np.float32(r))  # the fp32 product, as the reference gates

    dkey = _pack_cells(_cells(dst, origin, r), bits, dst_valid)
    keys_s, order = torch.sort(dkey, stable=True)
    dst_s = dst[order]

    # max cell occupancy (the exactness certificate): run lengths of the sorted keys
    runs = torch.unique_consecutive(keys_s[keys_s != _INVALID], return_counts=True)[1]
    max_occ = int(runs.max()) if runs.numel() else 0

    scell = _cells(src, origin, r)
    win = 3 * cell_cap
    ncand = 9 * win
    # over-select nothing: the smallest k keys are the answer. A key is the
    # bits of the squared distance above the candidate's column, so equal
    # distances keep candidate order whatever order topk gives to equal values
    ksel = min(k, ncand)
    cols = torch.arange(ncand, dtype=torch.int64, device=dev)
    window = torch.arange(win, dtype=torch.int64, device=dev)
    dz = torch.tensor([[dx, dy, -1] for dx, dy in _OFFSETS], dtype=torch.int64, device=dev)
    chunk = max(1, TILE_PAIRS // ncand)

    d2_out = torch.full((n, k), inf, dtype=torch.float32, device=dev)
    si_out = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, n, chunk):
        s, sv, sc = src[c0 : c0 + chunk], src_valid[c0 : c0 + chunk], scell[c0 : c0 + chunk]
        starts = []
        cand = []
        for o in range(9):
            nkey = _pack_cells(sc + dz[o], bits, sv)  # key of the dz = -1 cell
            start = torch.searchsorted(keys_s, nkey)
            idx = start[:, None] + window[None, :]
            safe = idx.clamp(0, m - 1)
            # the candidate must belong to one of the three consecutive
            # cells. The reference tests (ckey - nkey) <= 2 in unsigned
            # arithmetic; int64 needs the lower bound spelled out
            delta = keys_s[safe] - nkey[:, None]
            ok = (delta >= 0) & (delta <= 2) & (idx < m) & (nkey != _INVALID)[:, None]
            diff = s[:, None, :] - dst_s[safe]
            d2 = (diff * diff).sum(dim=2)
            cand.append(torch.where(ok, d2, inf))
            starts.append(start)
        cand_d = torch.cat(cand, dim=1)          # [C, 9 * win]
        starts = torch.stack(starts, dim=1)      # [C, 9]
        keys = (cand_d.view(torch.int32).to(torch.int64) << 32) | cols[None, :]
        best = torch.topk(keys, ksel, dim=1, largest=False, sorted=True).values
        col = best & 0xFFFFFFFF
        best_d = (best >> 32).to(torch.int32).view(torch.float32)
        best_i = torch.gather(starts, 1, col // win) + col % win
        gate = (best_d <= r2) & sv[:, None] & torch.isfinite(best_d)
        d2_out[c0 : c0 + chunk, :ksel] = torch.where(gate, best_d, inf)
        si_out[c0 : c0 + chunk, :ksel] = torch.where(gate, best_i, -1)
    idxs = torch.where(si_out >= 0, order[si_out.clamp(0, m - 1)], -1)
    return torch.sqrt(d2_out), idxs, max_occ


@torch.no_grad()
def grid_knn(src, dst, k: int, r: float, src_valid=None, dst_valid=None,
             cell_cap: int = 64, strict: bool = True, auto_grow: bool = True,
             device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest dst per src within radius r via uniform-grid bucketing, on
    the device of `src` (or `device`).

    Same contract as `neighbors.knn.knn` (dists inf / idxs -1 where missing,
    ascending). `r` must be a concrete float (it fixes the cell grid).

    When a cell exceeds cell_cap the results could miss neighbours; the
    max-occupancy certificate detects this and by default (auto_grow) the
    query reruns ONCE with cell_cap = next-pow2(max occupancy): medial points
    concentrate on the skeleton axis, so trunk-sized cells routinely exceed
    any fixed cap. With auto_grow=False, strict=True raises instead;
    strict=False returns the possibly-incomplete result.
    """
    src, dst, src_valid, dst_valid = _as_inputs(src, dst, src_valid, dst_valid, device)
    r = float(r)
    if dst.shape[0] == 0:
        return (src.new_full((src.shape[0], k), float("inf")),
                torch.full((src.shape[0], k), -1, dtype=torch.int64, device=src.device))

    # grid geometry from the data extent: reduced on the device, six floats
    # cross to the host. 2.5 r margin: a src up to r outside the dst box (the
    # farthest that can still have neighbours) must land at cell index >= 1
    # so its dz = -1 cell exists. bit_length(shape) (not shape - 1) leaves one
    # spare z code so key + 2 at the top cell never carries into the y field.
    lo, hi = (t.numpy() for t in torch.stack(_masked_extent(dst, dst_valid)).cpu())
    origin = (lo - np.float32(2.5 * r)).astype(np.float32)
    extent = hi - origin + np.float32(2.5 * r)
    shape = np.maximum(np.ceil(extent / np.float32(r)).astype(np.int64) + 1, 2)
    bits = tuple(int(s).bit_length() for s in shape)
    if sum(bits) > 32:
        raise ValueError(
            f"grid of {tuple(int(s) for s in shape)} cells needs {sum(bits)} key bits > 32; "
            "increase r or tile the cloud"
        )
    origin = torch.from_numpy(origin).to(src.device)

    d, i, max_occ = _grid_knn_impl(src, dst, src_valid, dst_valid, r, origin, k, bits,
                                   int(cell_cap))
    if max_occ > cell_cap:
        if auto_grow:
            grown = 1 << (max_occ - 1).bit_length()
            d, i, max_occ = _grid_knn_impl(src, dst, src_valid, dst_valid, r, origin, k,
                                           bits, grown)
            assert max_occ <= grown  # occupancy is data, not cap-dependent
        elif strict:
            raise RuntimeError(
                f"grid_knn: a cell holds {max_occ} > cell_cap={cell_cap} "
                "points; raise cell_cap (results would miss neighbours)"
            )
    return d, i
