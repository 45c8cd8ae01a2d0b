"""Greedy branch extraction (counterpart of `smart_tree_tpu/skeleton/path.py`).

Repeatedly: take the unallocated vertex farthest from its root, trace its
predecessors until an allocated vertex or the root, allocate every point
whose nearest path vertex is within that vertex's radius, and emit the path
as a branch. Each vertex belongs to at most one branch path, so paths are
encoded in place as (path_branch[v], path_pos[v]) and the host pulls the
packed result once. All state stays on the device, with a header of counts
and flags that each iteration reads and writes there: on the card one
iteration is three launches of csrc/tracer.cu, on the CPU the plain step
`greedy_step_plain`. The host queues ROUND iterations at a time and fetches
the header once a round; iterations queued past the end do nothing.

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

from ..core import kernels
from ..data.branch import BranchSkeleton
from ..device import resolve_device, settle_cpu_math
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
    `_select_path_points_windowed`)."""
    r_max = torch.where(path_valid, path_radii, 0.0).max()
    d, i = _knn_impl(points, path_pts, points_valid, path_valid, r_max**2, 1)
    d, i = d[:, 0], i[:, 0]
    return (i >= 0) & (d < path_radii[i.clamp_min(0)])


SEL_CHUNK = 128  # path vertices a window of the select (csrc/tracer.cu kWin)
# greedy iterations the host queues between two fetches of the header
ROUND = 32
_ROW_CHUNK = 4096  # valid vertices a window's distances are taken for at once

# the tracer's header, int64 slots (csrc/tracer.cu numbers them alike)
NO_WORK, CAP_HIT, COUNT, HOPS, ITERS, LIVE, LEN, TERM, HOP_HIT, PARENT = range(10)
HEADER = 10


def _select_path_points_windowed(points, points_valid, medial_pts, radii, path):
    """Mask of valid points whose nearest path vertex is within that
    vertex's radius, the arithmetic of csrc/tracer.cu's select. The path
    (true length, root side first) is swept in windows of SEL_CHUNK
    vertices. In a window, the nearest vertex by the exact form about the
    centre c of the window's bounding box, ((p - c) - (v - c)) squared and
    summed x, y, z in order, the lowest position of a tie; it counts when
    its d2 is within the window's largest radius squared. Across windows a
    running (best_d2, best_r) pair, best_d2 the square of the rounded root,
    carries the nearest vertex's radius (strict <), so the predicate is the
    one-shot form (nearest path vertex within ITS OWN radius), not an
    any-vertex-covers OR."""
    if points.device.type == "cpu":
        settle_cpu_math()
    rows = torch.nonzero(points_valid).squeeze(1)
    p = points[rows]
    best_d2 = p.new_full((rows.shape[0],), float("inf"))
    best_r = p.new_zeros(rows.shape[0])
    for i in range(0, path.shape[0], SEL_CHUNK):
        seg = path[i : i + SEL_CHUNK]
        v, r = medial_pts[seg], radii[seg]
        c = (v.min(dim=0).values + v.max(dim=0).values) * 0.5
        vc = v - c
        r_max = r.max()
        r2 = r_max * r_max
        for r0 in range(0, rows.shape[0], _ROW_CHUNK):
            rs = slice(r0, r0 + _ROW_CHUNK)
            diff = (p[rs] - c)[:, None, :] - vc[None, :, :]
            sq = diff * diff
            d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
            near = torch.argmin(d2, dim=1)
            dn = torch.gather(d2, 1, near[:, None])[:, 0]
            d = torch.sqrt(dn)
            dd = d * d
            closer = (dn <= r2) & (dd < best_d2[rs])
            best_r[rs] = torch.where(closer, r[near], best_r[rs])
            best_d2[rs] = torch.where(closer, dd, best_d2[rs])
    out = torch.zeros_like(points_valid)
    out[rows] = torch.isfinite(best_d2) & (torch.sqrt(best_d2) < best_r)
    return out


class _Tracer(NamedTuple):
    """The greedy loop's state, all on one device. The plain step reads
    `pts` to `header`; the kernels also use the scratch after it."""
    pts: torch.Tensor          # [N, 3] fp32
    radii: torch.Tensor        # [N] fp32
    jumps: torch.Tensor        # [L, N+1] int64 (build_jump_tables)
    dist: torch.Tensor         # [N] fp32 root distance, -1 once allocated or never a seed
    allocated: torch.Tensor    # [N+1] bool, the sentinel row set
    branch_ids: torch.Tensor   # [N] int64
    path_branch: torch.Tensor  # [N] int64
    path_pos: torch.Tensor     # [N] int64
    parents: torch.Tensor      # [max_branches] int64
    header: torch.Tensor       # [HEADER] int64
    chain: torch.Tensor        # [hop_cap] int32 predecessors, start side first
    path: torch.Tensor         # [hop_cap] int32 the path, root side first
    pathv: torch.Tensor        # [hop_cap, 4] fp32 path vertices centred on their window, radius
    win: torch.Tensor          # [ceil(hop_cap / SEL_CHUNK), 4] fp32 window centre, r_max^2


def _tracer_state(medial_pts, radii, preds, distances, component_mask, hop_cap: int,
                  max_branches: int) -> _Tracer:
    n = preds.shape[0]
    dev = preds.device
    dist = torch.where((preds > 0) & component_mask, distances, -1.0)
    dist = torch.where(torch.isfinite(dist), dist, -1.0).float().contiguous()
    allocated = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    allocated[n] = True  # the sentinel row of the jump tables

    def minus_one(m):
        return torch.full((m,), -1, dtype=torch.int64, device=dev)

    return _Tracer(
        medial_pts.float().contiguous(), radii.reshape(-1).float().contiguous(),
        build_jump_tables(preds.long(), hop_cap), dist, allocated, minus_one(n), minus_one(n),
        minus_one(n), minus_one(max_branches),
        torch.zeros(HEADER, dtype=torch.int64, device=dev),
        torch.empty(hop_cap, dtype=torch.int32, device=dev),
        torch.empty(hop_cap, dtype=torch.int32, device=dev),
        torch.empty((hop_cap, 4), dtype=torch.float32, device=dev),
        torch.empty((-(-hop_cap // SEL_CHUNK), 4), dtype=torch.float32, device=dev))


def greedy_step_plain(tr: _Tracer) -> None:
    """One greedy iteration on the state, in place: the plain version of
    csrc/tracer.cu, the same header writes included. Once an iteration found
    no work or hit the branch cap, every later one does nothing."""
    h = tr.header
    h[LIVE] = 0
    if h[NO_WORK] or h[CAP_HIT]:
        return
    farthest = torch.argmax(tr.dist)
    if not tr.dist[farthest] > 0:
        h[NO_WORK] = 1
        return
    if h[COUNT] >= tr.parents.shape[0]:
        h[CAP_HIT] = 1
        return
    hop_cap = tr.chain.shape[0]
    v, length, term = _trace_chain(tr.jumps, farthest, tr.allocated, hop_cap)
    length, term = int(length), int(term)
    # a trace that stopped only because of the hop cap (termination vertex
    # still unallocated) truncated a path
    hop_hit = length >= hop_cap and term >= 0 and not tr.allocated[term]
    parent = int(tr.branch_ids[term]) if term >= 0 else -1
    # only real path vertices are written: no padding slot aliases vertex 0
    path = v[:length].flip(0)
    on_path = _select_path_points_windowed(tr.pts, tr.dist >= 0, tr.pts, tr.radii, path)
    n = tr.dist.shape[0]
    tr.allocated[:n] |= on_path
    tr.allocated[path] = True
    tr.dist.masked_fill_(on_path, -1.0)
    tr.dist[path] = -1.0
    bid = int(h[COUNT])
    if length >= 2:
        tr.branch_ids.masked_fill_(on_path, bid)
        tr.branch_ids[path] = bid
        tr.path_branch[path] = bid
        tr.path_pos[path] = torch.arange(length, dtype=torch.int64, device=path.device)
        tr.parents[bid] = parent
        h[COUNT] = bid + 1
    h[LIVE], h[LEN], h[TERM], h[HOP_HIT], h[PARENT] = 1, length, term, int(hop_hit), parent
    h[HOPS] += int(hop_hit)
    h[ITERS] += 1


def greedy_steps(tr: _Tracer, steps: int) -> None:
    """Queue `steps` greedy iterations: on CUDA tensors csrc/tracer.cu's
    three launches each (raising if a launch fails), on CPU tensors
    `greedy_step_plain`. Nothing is fetched."""
    dev = tr.dist.device
    if dev.type == "cpu":
        for _ in range(steps):
            greedy_step_plain(tr)
        return
    if dev.type != "cuda":
        raise ValueError(f"the tracer runs on cuda or cpu, not {dev}")
    n, hop_cap = tr.dist.shape[0], tr.chain.shape[0]
    if n + 1 >= 1 << 31:
        raise ValueError("the tracer takes fewer than 2^31 - 1 vertices")
    rc = kernels.load().st_tracer_steps(
        tr.pts.data_ptr(), tr.radii.data_ptr(), tr.jumps.data_ptr(), tr.jumps.shape[0], n,
        tr.dist.data_ptr(), tr.allocated.data_ptr(), tr.branch_ids.data_ptr(),
        tr.path_branch.data_ptr(), tr.path_pos.data_ptr(), tr.parents.data_ptr(),
        tr.parents.shape[0], hop_cap, tr.chain.data_ptr(), tr.path.data_ptr(),
        tr.pathv.data_ptr(), tr.win.data_ptr(), tr.header.data_ptr(), steps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(rc, "st_tracer_steps")
    greedy_steps.launches += 3 * steps


greedy_steps.launches = 0


def _rounds(tr: _Tracer, steps, stats: dict | None = None):
    """Run the greedy loop in rounds of ROUND iterations queued by
    `steps(tr, ROUND)` and one fetch of the header a round (with the parents
    of the round's branches), until an iteration finds no work or hits the
    branch cap. Returns (the last header, as a list, and the parents)."""
    parents: list[int] = []
    while True:
        with span(stats, "skeleton.trace_branch"):
            steps(tr, ROUND)
            done = len(parents)
            got = torch.cat([tr.header, tr.parents[done : done + ROUND]]).tolist()
            count(stats, "tracer_fetches")
        hdr = got[:HEADER]
        parents += got[HEADER : HEADER + hdr[COUNT] - done]
        if hdr[NO_WORK] or hdr[CAP_HIT]:
            return hdr, parents
        if hdr[ITERS] > tr.dist.shape[0]:  # each iteration allocates its seed
            raise RuntimeError(f"the tracer ran {hdr[ITERS]} iterations over "
                               f"{tr.dist.shape[0]} vertices without finishing")


@torch.no_grad()
def sample_tree_device(medial_pts, medial_radii, preds, distances, component_mask,
                       hop_cap: int = 2048, max_branches: int = 4096,
                       stats: dict | None = None) -> SampleTreeResult:
    """The greedy loop on the device of `preds`. `stats`, when given, counts
    the host fetches (`tracer_fetches`: one a round, the last included) and
    the real iterations (`tracer_iterations`); each round is a
    `skeleton.trace_branch` span (utils/trace.py)."""
    tr = _tracer_state(medial_pts, medial_radii, preds, distances, component_mask, hop_cap,
                       max_branches)
    hdr, parents = [0] * HEADER, []
    if preds.shape[0]:
        hdr, parents = _rounds(tr, greedy_steps, stats)
        count(stats, "tracer_iterations", hdr[ITERS])
    log.debug("sample_tree_device: %d greedy iterations", hdr[ITERS])
    return SampleTreeResult(
        path_branch=tr.path_branch,
        path_pos=tr.path_pos,
        branch_ids=tr.branch_ids,
        branch_parents=np.asarray(parents, np.int64),
        branch_count=hdr[COUNT],
        hop_cap_hits=hdr[HOPS],
        branch_cap_hit=bool(hdr[CAP_HIT]),
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
