"""Shortest paths with predecessors (counterpart of
`smart_tree_tpu/graph/sssp.py`, its gather form):

  sssp_multi:      Bellman-Ford relaxation over the neighbor table,
                   `min(dist, row-min(dist[tbl.idx] + tbl.w))` per round, one
                   [n, cap] gather and no scatter, until a round makes no
                   progress; predecessors recovered afterwards because the
                   converged distances satisfy dist[v] = dist[pred] + w.
  tree_distances:  on the predecessor tree root distances accumulate by
                   pointer doubling in O(log n) steps.

The port has this one formulation for the CPU and the card; the JAX package's
scatter form gives the same bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .table import NeighborTable, build_neighbor_table

_INF = float("inf")


def sssp(edges, weights, edge_valid, source, num_vertices: int):
    """Undirected weighted shortest paths from one source: `sssp_multi` with
    a single source. Returns (dist [n] float32, pred [n] int64)."""
    src = torch.as_tensor(source, dtype=torch.int64, device=edges.device).reshape(1)
    return sssp_multi(edges, weights, edge_valid, src, num_vertices)


def _dist_init(sources, num_vertices: int):
    """+inf everywhere, 0 at the sources (-1 entries are padding)."""
    dist = torch.full((num_vertices,), _INF, device=sources.device)
    dist[sources[sources >= 0]] = 0.0
    return dist


def _bf_rounds(tbl_idx, tbl_w, dist, tol: float, sc_idx=None, sc_w=None):
    """Relaxation rounds until none makes progress: (dist, rounds run, the
    last one included). With a source-aligned shortcut table each round also
    relaxes over each vertex's own composite endpoints.

    Improvements are always applied exactly, but only count as progress when
    they exceed `tol` (relative, plus the same absolute floor): with
    shortcuts, composite path sums differ from sequential sums by addition
    order, and an exact change detector would chase that ulp-level wave one
    hop per round. The check runs every round (one scalar fetch): rounds
    past the rule would apply sub-tolerance refinements that can flip a
    predecessor at a near-tie."""
    rounds = 0
    while True:
        new = torch.minimum(dist, (dist[tbl_idx] + tbl_w).min(dim=1).values)
        if sc_idx is not None:
            new = torch.minimum(new, (dist[sc_idx] + sc_w).min(dim=1).values)
        thresh = torch.where(torch.isfinite(dist), dist - tol * dist - tol, _INF)
        rounds += 1
        changed = bool((new < thresh).any())
        dist = new
        if not changed:
            return dist, rounds


def _pred_tbl(table: NeighborTable, sources, dist, num_vertices: int):
    """Predecessors over the neighbor table. A neighbor u of v qualifies
    when dist[u] + w <= dist[v] + tol (bit-exact matching is brittle: the KNN
    graph stores (i,j) and (j,i) with independently rounded weights) and the
    step is acyclic (strict dist decrease, or equal dist broken by vertex
    id); the lowest qualifying id wins. Entries with real=False are
    excluded, as are self-loops."""
    n = num_vertices
    u, w = table.idx, table.w
    vid = torch.arange(n, dtype=u.dtype, device=u.device)[:, None]
    dv = dist[:, None]
    du = dist[u]
    tol = 1e-5 * dv.abs() + 1e-5
    near = du + w <= dv + tol
    acyclic = (du < dv) | ((du == dv) & (u < vid))
    hit = table.real & near & acyclic & torch.isfinite(dv) & (u != vid)
    cand = torch.where(hit, u, n).min(dim=1).values
    pred = torch.where(cand < n, cand, -1)
    # only real sources: a -1 padding entry must not touch vertex 0
    pred[sources[sources >= 0]] = -1
    return pred


@torch.no_grad()
def sssp_multi(edges, weights, edge_valid, sources, num_vertices: int,
               return_rounds: bool = False, shortcut_tbl=None,
               table: NeighborTable | None = None):
    """Undirected weighted shortest paths from several sources in one
    Bellman-Ford pass. Component vertex sets are disjoint, so seeding every
    component's root at distance 0 solves all of them at once.

    edges [E,2] int64, weights [E] float32 >= 0, edge_valid [E] bool,
    sources [S] int64 (-1 entries are padding).
    `shortcut_tbl`: optional aligned (idx2 [n,S], w2 [n,S]) table from
    `chain_shortcut_table`, used for relaxation only. `table`: optional
    prebuilt NeighborTable over the same edges.

    Returns (dist [n] float32, inf if unreachable from every source;
             pred [n] int64, -1 at the sources and at unreachable vertices)
    and the round count when `return_rounds`."""
    n = num_vertices
    if table is None:
        table = build_neighbor_table(edges, weights, edge_valid, n)
    # with shortcuts, sub-tolerance (addition-order) refinements must not
    # count as progress; 1e-6 m is geometrically nil and well under
    # _pred_tbl's 1e-5 tolerance
    sc = shortcut_tbl if shortcut_tbl is not None else (None, None)
    tol = 1e-6 if shortcut_tbl is not None else 0.0
    sources = torch.as_tensor(sources, dtype=torch.int64, device=table.idx.device)
    dist, rounds = _bf_rounds(table.idx, table.w, _dist_init(sources, n), tol, *sc)
    pred = _pred_tbl(table, sources, dist, n)
    if return_rounds:
        return dist, pred, rounds
    return dist, pred


@torch.no_grad()
def tree_distances(pred, step_weight, num_vertices: int) -> torch.Tensor:
    """Root distance along a predecessor tree by pointer doubling.
    pred [n] int64 (-1 at roots), step_weight [n] float32 (distance from
    each vertex to its predecessor; ignored at roots)."""
    n = num_vertices
    d = torch.where(pred >= 0, step_weight, 0.0)
    p = pred
    for _ in range(max(int(n - 1).bit_length(), 1)):
        has = p >= 0
        pc = p.clamp(0, max(n - 1, 0))
        d = d + torch.where(has, d[pc], 0.0)
        p = torch.where(has, p[pc], p)
    return d
