"""Connected components by min-label propagation (counterpart of
`smart_tree_tpu/graph/components.py`): every vertex carries the minimum
vertex id of its component; each round pulls the row-min of its neighbors'
labels from the neighbor table, then pointer-doubles. One scalar fetch per
round checks convergence.
"""

from __future__ import annotations

import torch

from .table import NeighborTable, build_neighbor_table


def _cc_rounds(tbl_idx, tbl_w, num_vertices: int, sc_idx=None, sc_w=None):
    """(labels [n] int64, rounds run)."""
    n = num_vertices
    empty = ~torch.isfinite(tbl_w)
    sc_empty = None if sc_w is None else ~torch.isfinite(sc_w)
    labels = torch.arange(n, dtype=torch.int64, device=tbl_idx.device)
    rounds = 0
    while True:
        lnbr = labels[tbl_idx].masked_fill_(empty, n)
        new = torch.minimum(labels, lnbr.min(dim=1).values)
        if sc_idx is not None:
            # shortcut endpoints are same-component by construction
            lsc = new[sc_idx].masked_fill_(sc_empty, n)
            new = torch.minimum(new, lsc.min(dim=1).values)
        for _ in range(2):  # labels form a decreasing pointer forest
            new = torch.minimum(new, new[new])
        rounds += 1
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            return labels, rounds


@torch.no_grad()
def connected_components(edges, edge_valid, num_vertices: int, vertex_valid=None,
                         table: NeighborTable | None = None, shortcut_tbl=None
                         ) -> torch.Tensor:
    """labels [num_vertices] int64: min vertex id of each component.
    Invalid vertices keep their own id. `table`: a prebuilt NeighborTable
    over the same edges; `shortcut_tbl`: an aligned (idx2, w2) table from
    `chain_shortcut_table`."""
    n = num_vertices
    if table is None:
        table = build_neighbor_table(
            edges, torch.zeros(edges.shape[0], device=edges.device), edge_valid, n
        )
    sc = shortcut_tbl if shortcut_tbl is not None else (None, None)
    labels, _ = _cc_rounds(table.idx, table.w, n, sc[0], sc[1])
    if vertex_valid is not None:
        labels = torch.where(vertex_valid, labels, torch.arange(n, device=labels.device))
    return labels


def component_sizes(labels, vertex_valid) -> torch.Tensor:
    """[num_vertices] int64 size of the component rooted at each label id
    (0 elsewhere)."""
    return torch.zeros_like(labels).index_add_(0, labels, vertex_valid.to(labels.dtype))
