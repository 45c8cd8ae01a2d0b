"""Greedy branch extraction (counterpart of `smart_tree_tpu/skeleton/path.py`).

Repeatedly: take the unallocated vertex farthest from its root, trace its
predecessors until an allocated vertex or the root, allocate every point
whose nearest path vertex is within that vertex's radius, and emit the path
as a branch. Each vertex belongs to at most one branch path, so paths are
encoded in place as (path_branch[v], path_pos[v]) and the host pulls the
packed result once. The loop runs eagerly: all state stays on the device and
each branch costs one scalar fetch.

Semantics kept from the original smart-tree: vertices with pred <= 0 are
never seeds (`preds > 0`, the vertex-0 quirk included); paths shorter than 2
vertices allocate points but emit no branch; parent_id is the branch owning
the termination vertex (-1 for the first branch).
"""

from __future__ import annotations

import logging
from typing import Dict, NamedTuple

import numpy as np
import torch

from ..data.branch import BranchSkeleton
from ..device import resolve_device
from ..neighbors.knn import _knn_impl
from ..utils.trace import count, span

log = logging.getLogger(__name__)


class SampleTreeResult(NamedTuple):
    path_branch: torch.Tensor   # [N] int64 branch id whose path contains v (-1)
    path_pos: torch.Tensor      # [N] int64 position of v along its path
    branch_ids: torch.Tensor    # [N] int64 owning branch per allocated vertex
    branch_parents: np.ndarray  # [branch_count] int64 parent branch id
    branch_count: int
    hop_cap_hits: int           # traces truncated at hop_cap
    branch_cap_hit: bool        # loop stopped with work left


def trace_route(preds, start: int, allocated, hop_cap: int):
    """Hop predecessors from `start` until reaching an allocated vertex or
    the root (-1 pred). Returns (path [length] int64, root-side first;
    length; termination vertex or -1). One hop at a time on the host: the
    oracle for trace_route_jump."""
    preds = preds.tolist()
    allocated = allocated.tolist()
    path, idx = [], int(start)
    while idx >= 0 and len(path) < hop_cap and not allocated[idx]:
        path.append(idx)
        idx = preds[idx]
    return torch.tensor(path[::-1], dtype=torch.int64), len(path), idx


def build_jump_tables(preds, hop_cap: int):
    """Pointer-doubling ancestor tables: jumps[k][v] = 2^k-th predecessor of
    v, over an index space where row n is an absorbing sentinel (roots' pred
    -1 maps to it). [L, N+1] with L = hop_cap.bit_length(), so any ancestor
    up to pred^hop_cap is a bit-decomposed composition of table rows."""
    n = preds.shape[0]
    levels = max(1, int(hop_cap).bit_length())
    base = torch.cat([torch.where(preds >= 0, preds, n),
                      torch.tensor([n], dtype=preds.dtype, device=preds.device)])
    tables = [base]
    for _ in range(levels - 1):
        t = tables[-1]
        tables.append(t[t])
    return torch.stack(tables)


def _trace_chain(jumps, start, allocated_ext, hop_cap: int):
    """Device half of trace_route_jump: (v [hop_cap] chain start-side first,
    length, term), length and term as 0-d tensors. `allocated_ext` is
    allocated with a True appended for the sentinel row."""
    n = allocated_ext.shape[0] - 1
    j = torch.arange(hop_cap, dtype=torch.int64, device=jumps.device)
    v = start.expand(hop_cap)
    vh = start
    for k in range(jumps.shape[0]):
        v = torch.where((j >> k) & 1 == 1, jumps[k][v], v)
        # pred^hop_cap(start): the sequential trace's `term` when hop-capped
        if (hop_cap >> k) & 1:
            vh = jumps[k][vh]
    stop = allocated_ext[v]  # allocated, or past the root
    has_stop = stop.any()
    first_stop = torch.argmax(stop.to(torch.uint8))
    length = torch.where(has_stop, first_stop, hop_cap)
    v_stop = v[first_stop]
    term = torch.where(has_stop, v_stop, vh)
    return v, length, torch.where(term < n, term, -1)


def trace_route_jump(jumps, start, allocated, hop_cap: int):
    """trace_route in log2(hop_cap) parallel steps: materialise the whole
    ancestor chain v[j] = pred^j(start) with bit-decomposed jumps, then find
    the first terminator (allocated vertex or past-root sentinel) in one
    scan. Same result as trace_route."""
    start = torch.as_tensor(start, dtype=torch.int64, device=jumps.device)
    ext = torch.cat([allocated, allocated.new_ones(1)])
    v, length, term = _trace_chain(jumps, start, ext, hop_cap)
    length = int(length)
    return v[:length].flip(0), length, int(term)


@torch.no_grad()
def select_path_points(points, points_valid, path_pts, path_radii, path_valid):
    """Mask of points whose nearest valid path vertex is within that vertex's
    radius, the whole path at once (the tracer sweeps it in windows,
    `_select_path_points_chunked`)."""
    r_max = torch.where(path_valid, path_radii, 0.0).max()
    d, i = _knn_impl(points, path_pts, points_valid, path_valid, r_max**2, 1)
    d, i = d[:, 0], i[:, 0]
    return (i >= 0) & (d < path_radii[i.clamp_min(0)])


SEL_CHUNK = 128


def _select_path_points_chunked(points, points_valid, medial_pts, radii, path):
    """Mask of points whose nearest path vertex is within that vertex's
    radius. The path (true length, no padding) is swept in windows of
    SEL_CHUNK vertices; a running (best_d2, best_r) pair carries the nearest
    vertex's radius across windows, so the predicate is the one-shot form
    (nearest path vertex within ITS OWN radius), not an any-vertex-covers
    OR."""
    n = points.shape[0]
    best_d2 = points.new_full((n,), float("inf"))
    best_r = points.new_zeros(n)
    for i in range(0, path.shape[0], SEL_CHUNK):
        seg = path[i : i + SEL_CHUNK]
        seg_pts, seg_r = medial_pts[seg], radii[seg]
        svalid = torch.ones(seg.shape[0], dtype=torch.bool, device=seg.device)
        d, j = _knn_impl(points, seg_pts, points_valid, svalid, seg_r.max() ** 2, 1)
        d, j = d[:, 0], j[:, 0]
        d2 = torch.where(j >= 0, d * d, float("inf"))
        closer = d2 < best_d2
        best_r = torch.where(closer, seg_r[j.clamp_min(0)], best_r)
        best_d2 = torch.minimum(best_d2, d2)
    return torch.isfinite(best_d2) & (torch.sqrt(best_d2) < best_r)


@torch.no_grad()
def sample_tree_device(medial_pts, medial_radii, preds, distances, component_mask,
                       hop_cap: int = 2048, max_branches: int = 4096,
                       stats: dict | None = None) -> SampleTreeResult:
    """The greedy loop on the device. `stats`, when given, counts the host
    fetches (`tracer_fetches`: one a greedy iteration, the last one's finding
    no work included); each iteration is a `skeleton.trace_branch` span
    (utils/trace.py)."""
    n = preds.shape[0]
    dev = preds.device
    radii = medial_radii.reshape(-1)
    dist = torch.where((preds > 0) & component_mask, distances, -1.0)
    dist = torch.where(torch.isfinite(dist), dist, -1.0)
    allocated = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    allocated[n] = True  # the sentinel row of the jump tables
    branch_ids = torch.full((n,), -1, dtype=torch.int64, device=dev)
    path_branch = torch.full((n,), -1, dtype=torch.int64, device=dev)
    path_pos = torch.full((n,), -1, dtype=torch.int64, device=dev)
    parents: list[int] = []
    hop_hits = 0
    cap_hit = False
    iters = 0
    jumps = build_jump_tables(preds, hop_cap)

    while n:
        with span(stats, "skeleton.trace_branch"):
            farthest = torch.argmax(dist)
            v, length, term = _trace_chain(jumps, farthest, allocated, hop_cap)
            tsafe = term.clamp_min(0)
            # a trace that stopped only because of the hop cap (termination
            # vertex still unallocated) truncated a path
            hop_hit = (length >= hop_cap) & (term >= 0) & ~allocated[tsafe]
            parent = torch.where(term >= 0, branch_ids[tsafe], -1)
            # the one fetch of this branch
            work, length, hop_hit, parent = torch.stack(
                [(dist[farthest] > 0).long(), length, hop_hit.long(), parent]
            ).tolist()
            count(stats, "tracer_fetches")
            if not work:
                break
            if len(parents) >= max_branches:
                cap_hit = True
                break
            iters += 1
            hop_hits += hop_hit
            # only real path vertices are written: no padding slot aliases
            # vertex 0
            path = v[:length].flip(0)
            on_path = _select_path_points_chunked(
                medial_pts, dist >= 0, medial_pts, radii, path
            )
            # masked fills, not boolean-index writes, which would fetch a count
            allocated[:n] |= on_path
            allocated[path] = True
            dist.masked_fill_(on_path, -1.0)
            dist[path] = -1.0
            if length >= 2:
                bid = len(parents)
                branch_ids.masked_fill_(on_path, bid)
                branch_ids[path] = bid
                path_branch[path] = bid
                path_pos[path] = torch.arange(length, dtype=torch.int64, device=dev)
                parents.append(parent)

    log.debug("sample_tree_device: %d greedy iterations", iters)
    return SampleTreeResult(
        path_branch=path_branch,
        path_pos=path_pos,
        branch_ids=branch_ids,
        branch_parents=np.asarray(parents, np.int64),
        branch_count=len(parents),
        hop_cap_hits=hop_hits,
        branch_cap_hit=cap_hit,
    )


def _branch_vertex_runs(path_branch, path_pos, count):
    """Yield (branch id, ordered member vertex ids) for every emitted branch
    with >= 2 vertices, from the packed in-place path encoding (numpy)."""
    member = path_branch >= 0
    order = np.lexsort((path_pos[member], path_branch[member]))
    verts = np.nonzero(member)[0][order]
    bids = path_branch[member][order]
    starts = np.searchsorted(bids, np.arange(count))
    ends = np.searchsorted(bids, np.arange(count), side="right")
    for b in range(count):
        v = verts[starts[b] : ends[b]]
        if len(v) >= 2:
            yield b, v


def _traced(what, medial_pts, radii, preds, distances, component_mask, hop_cap,
            max_branches, strict, host_pts, host_radii, stats=None):
    """Run the greedy loop, check the caps (strict: raise when either
    truncated real work) and pull the result once: (branch vertex runs,
    parents, host points, host radii)."""
    res = sample_tree_device(medial_pts, radii, preds, distances, component_mask,
                             hop_cap, max_branches, stats)
    if stats is not None:
        stats["branches"] = res.branch_count
    if strict:
        if res.hop_cap_hits:
            raise RuntimeError(
                f"{what}: {res.hop_cap_hits} trace(s) truncated at "
                f"hop_cap={hop_cap}; raise hop_cap"
            )
        if res.branch_cap_hit:
            raise RuntimeError(
                f"{what}: unallocated vertices remain at "
                f"max_branches={max_branches}; raise max_branches"
            )
    path_branch, path_pos = torch.stack([res.path_branch, res.path_pos]).cpu().numpy()
    pts = host_pts if host_pts is not None else medial_pts.cpu().numpy()
    rad = (host_radii if host_radii is not None else radii.cpu().numpy()).reshape(-1)
    runs = _branch_vertex_runs(path_branch, path_pos, res.branch_count)
    return runs, res.branch_parents, pts, rad


def sample_tree(medial_pts, medial_radii, preds, distances, component_mask,
                hop_cap: int = 2048, max_branches: int = 4096, strict: bool = True,
                host_pts: np.ndarray | None = None, host_radii: np.ndarray | None = None,
                device=None) -> Dict[int, BranchSkeleton]:
    """Host wrapper for one tree: run the greedy loop on `device` (the card
    unless another is named; numpy or tensor inputs), pull once, assemble
    {branch id: BranchSkeleton}.

    strict=True raises when either cap truncated real work; strict=False
    keeps the truncated result. `host_pts` / `host_radii`: numpy copies of
    the points and radii where the caller already holds them."""
    dev = resolve_device(device)
    medial_pts = torch.as_tensor(medial_pts, dtype=torch.float32, device=dev)
    radii = torch.as_tensor(medial_radii, dtype=torch.float32, device=dev).reshape(-1)
    runs, parents, pts, rad = _traced(
        "sample_tree", medial_pts, radii,
        torch.as_tensor(preds, dtype=torch.int64, device=dev),
        torch.as_tensor(distances, dtype=torch.float32, device=dev),
        torch.as_tensor(component_mask, dtype=torch.bool, device=dev),
        hop_cap, max_branches, strict, host_pts, host_radii)
    return {b: BranchSkeleton(b, int(parents[b]), pts[v], rad[v].reshape(-1, 1))
            for b, v in runs}


def sample_forest(medial_pts, medial_radii, preds, distances, component_mask,
                  labels_np: np.ndarray, hop_cap: int = 2048,
                  max_branches: int = 4096, strict: bool = True,
                  host_pts: np.ndarray | None = None,
                  host_radii: np.ndarray | None = None, stats: dict | None = None,
                  ) -> Dict[int, Dict[int, BranchSkeleton]]:
    """Branches of the UNION of all selected components in one run, split
    per component afterwards.

    Equivalent to one run per component up to branch renumbering:
    allocation state is per vertex and components are vertex-disjoint, so
    extracting a branch in one component never changes another component's
    farthest-unallocated sequence; traces follow predecessors, which stay
    within a component; parents own termination vertices, also
    same-component. Per-component ids are assigned by extraction order.

    strict, host_pts and host_radii as for `sample_tree`.

    Returns {component label: {branch id: BranchSkeleton}}.
    """
    radii = medial_radii.reshape(-1)
    runs, parents, pts, rad = _traced(
        "sample_forest", medial_pts, radii, preds, distances, component_mask, hop_cap,
        max_branches, strict, host_pts, host_radii, stats)

    # split by component and renumber by extraction order (global branch
    # ids are monotone in extraction order)
    out: Dict[int, Dict[int, BranchSkeleton]] = {}
    local_id: Dict[int, int] = {}
    for b, v in runs:
        comp_branches = out.setdefault(int(labels_np[v[0]]), {})
        lb = len(comp_branches)
        local_id[b] = lb
        gp = int(parents[b])
        lp = local_id.get(gp, -1) if gp >= 0 else -1
        comp_branches[lb] = BranchSkeleton(lb, lp, pts[v], rad[v].reshape(-1, 1))
    return out
