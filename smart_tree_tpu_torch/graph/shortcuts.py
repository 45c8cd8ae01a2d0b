"""Chain-shortcut edges (counterpart of `smart_tree_tpu/graph/shortcuts.py`):
composites of exponential reach that collapse Bellman-Ford round counts on
filament graphs.

Exact relaxation advances one hop per round, so rounds = hop depth of the
shortest-path forest, thousands on a tall tree at 1 cm cells. Level l holds,
per vertex, the `keep` farthest endpoints reachable by composing two
level-(l-1) shortcuts: real path lengths, so relaxing over them can never
undercut a true shortest path, while reach doubles per level. Predecessor
extraction stays on the original edges.

Many scores are equal (-inf at empty slots), so every selection is a stable
sort: the lowest column wins among equals.
"""

from __future__ import annotations

from typing import Tuple

import torch

_INF = float("inf")


def _farthest(score, keep: int):
    """Columns of the `keep` largest scores per row, lowest column first
    among equals."""
    return torch.sort(-score, dim=1, stable=True).indices[:, :keep]


def _shortcut_levels(idxs, dists, valid, levels: int, keep: int):
    """Per-level [N, keep] composite endpoints, weights and valid masks,
    concatenated over levels."""
    n = idxs.shape[0]
    vid = torch.arange(n, dtype=idxs.dtype, device=idxs.device)

    # level-0 seeds: the `keep` farthest real neighbors
    order = _farthest(torch.where(valid, dists, -_INF), keep)
    cur_i = torch.gather(idxs, 1, order)
    cur_v = torch.gather(valid, 1, order) & (cur_i >= 0)
    cur_d = torch.where(cur_v, torch.gather(dists, 1, order), _INF)
    cur_i = torch.where(cur_v, cur_i, -1)
    width = cur_i.shape[1]

    out_i, out_d, out_v = [], [], []
    for _ in range(levels):
        mid = cur_i.clamp_min(0)
        hop_i = cur_i[mid]                          # [N, width, width]
        hop_ok = cur_v[:, :, None] & cur_v[mid] & (hop_i >= 0)
        hop_ok &= hop_i != vid[:, None, None]       # drop round trips to self
        hop_d = cur_d[:, :, None] + cur_d[mid]
        sel = _farthest(torch.where(hop_ok, hop_d, -_INF).reshape(n, -1), keep)
        cur_i = torch.gather(hop_i.reshape(n, -1), 1, sel)
        cur_v = torch.gather(hop_ok.reshape(n, -1), 1, sel)
        cur_d = torch.where(cur_v, torch.gather(hop_d.reshape(n, -1), 1, sel), _INF)
        cur_i = torch.where(cur_v, cur_i, -1)
        out_i.append(cur_i)
        out_d.append(cur_d)
        out_v.append(cur_v)
    return torch.cat(out_i, dim=1), torch.cat(out_d, dim=1), torch.cat(out_v, dim=1)


@torch.no_grad()
def chain_shortcuts(idxs, dists, valid, levels: int = 8, keep: int = 4
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat shortcut edges from a [N, k] KNN adjacency (idxs -1 = missing,
    valid = edge usable): (edges [N*levels*keep, 2], weights, valid)."""
    n = idxs.shape[0]
    ci, cd, cv = _shortcut_levels(idxs, dists, valid, levels, keep)
    w = cd.reshape(-1)
    ev = cv.reshape(-1) & torch.isfinite(w)
    src = torch.arange(n, dtype=idxs.dtype, device=idxs.device)[:, None].expand_as(ci)
    edges = torch.stack([src.reshape(-1), ci.reshape(-1).clamp_min(0)], dim=1)
    return edges, torch.where(ev, w, _INF), ev


@torch.no_grad()
def chain_shortcut_table(idxs, dists, valid, levels: int = 10, keep: int = 4
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source-aligned shortcut table: (idx2 [N, levels*keep] int64,
    w2 float32, inf where empty). Row v holds v's own composite endpoints,
    so relaxation is one more fixed-width gather per round, valid by path
    symmetry on an undirected graph; the main table's cap never widens."""
    ci, cd, cv = _shortcut_levels(idxs, dists, valid, levels, keep)
    ok = cv & torch.isfinite(cd)
    return torch.where(ok, ci, 0), torch.where(ok, cd, _INF)
