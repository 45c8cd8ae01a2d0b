"""Gather-form neighbor table (counterpart of `smart_tree_tpu/graph/table.py`):
the bounded-degree adjacency that the iterative graph algorithms read, one
`[n, cap]` gather per round and a row-min, with no scatter.

Build: both edge directions are sorted by destination (stable), per-vertex
segments located by searchsorted, and the table gathered from the sorted
arrays at `start[v] + arange(cap)`. Degree overflow beyond `cap` is counted;
`build_neighbor_table` retries with a doubled cap, so the table is always
exact.

`real` marks entries that come from original edges (True) against auxiliary
relaxation-only edges; predecessor extraction ignores the latter.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class NeighborTable(NamedTuple):
    idx: torch.Tensor   # [n, cap] int64 neighbor vertex (0 where empty)
    w: torch.Tensor     # [n, cap] float32 edge weight (inf where empty)
    real: torch.Tensor  # [n, cap] bool: entry from an original (non-aux) edge


def _build(srcs, dsts, ws, vals, reals, num_vertices: int, cap: int
           ) -> Tuple[NeighborTable, int]:
    """(table, number of incident edges that did not fit `cap`)."""
    n = num_vertices
    e2 = srcs.shape[0]
    dev = srcs.device
    if e2 == 0:
        return NeighborTable(
            torch.zeros((n, cap), dtype=torch.int64, device=dev),
            torch.full((n, cap), float("inf"), device=dev),
            torch.zeros((n, cap), dtype=torch.bool, device=dev)), 0
    key = torch.where(vals, dsts, n)  # invalid edges sort past every vertex
    sd, order = torch.sort(key, stable=True)
    ov = vals[order]
    ss = torch.where(ov, srcs[order], 0)
    sw = torch.where(ov, ws[order], float("inf"))
    sr = reals[order] & ov
    vid = torch.arange(n, dtype=sd.dtype, device=dev)
    start = torch.searchsorted(sd, vid, right=False)
    end = torch.searchsorted(sd, vid, right=True)
    pos = start[:, None] + torch.arange(cap, dtype=start.dtype, device=dev)[None, :]
    ok = pos < end[:, None]
    posc = pos.clamp(0, e2 - 1)
    tbl = NeighborTable(
        idx=torch.where(ok, ss[posc], 0),
        w=torch.where(ok, sw[posc], float("inf")),
        real=ok & sr[posc],
    )
    overflow = int((end - start - cap).clamp_min(0).sum())
    return tbl, overflow


def symmetrized(edges, weights, edge_valid, real: bool = True):
    """Both directions of an undirected edge list as the flat arrays
    `_build` takes: (srcs, dsts, ws, vals, reals)."""
    u, v = edges[:, 0], edges[:, 1]
    vals = torch.cat([edge_valid, edge_valid])
    return (torch.cat([u, v]), torch.cat([v, u]), torch.cat([weights, weights]),
            vals, torch.full_like(vals, real))


@torch.no_grad()
def build_neighbor_table(edges, weights, edge_valid, num_vertices: int,
                         extra=None, cap: int = 48, max_cap: int = 4096
                         ) -> NeighborTable:
    """Symmetrized [n, cap] neighbor table from an undirected edge list.

    edges [E,2] int64, weights [E] float32, edge_valid [E] bool.
    extra: optional (edges, weights, valid) of auxiliary relaxation-only
    edges, included with real=False.
    cap: initial per-vertex capacity; doubled on overflow until every
    incident edge fits (one scalar fetch per attempt)."""
    parts = [symmetrized(edges, weights, edge_valid)]
    if extra is not None:
        parts.append(symmetrized(*extra, real=False))
    flat = [torch.cat(cols) for cols in zip(*parts)]
    while True:
        tbl, overflow = _build(*flat, num_vertices, cap)
        if overflow == 0:
            return tbl
        if cap >= max_cap:
            raise RuntimeError(
                f"neighbor table overflow at cap={cap} ({overflow} edges "
                f"dropped); degree exceeds max_cap={max_cap}: a hub vertex "
                "(duplicate points?) in the graph"
            )
        cap = min(cap * 2, max_cap)
