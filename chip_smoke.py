#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (smart_tree_tpu_torch) on one
NVIDIA card (written for the H100, sm_90a).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
     TF32 off;
  3. kernels: on the plans of the bench tree's batches, hold the slab
     kernel against its plain version at every (Cin, Cout) the bf16 forward
     gives it, and the fused kernel at every (K3, Cin, Cout) the fp32
     fused=True forward gives it, each at its tallest rulebook; launch each
     twice on one input and require equal bits; time each with CUDA events
     (through the wrapper, `ms`, and as the bare launch, `kernel_ms`) beside
     the plain version, the gather + torch.matmul composition (library_ms)
     and the least time the card could take;
  4. bf16 forward of the bench tree (generate_tree seed 0, 12 m,
     noble-elevator-58, batch capacity <= 262144): one warm-up, counts
     reset, three timed forwards; the slab kernel must have launched; then
     one more forward under torch.profiler for the slab kernel's summed
     device time and launches inside one forward;
  5. fp32 forward with fused=True (fused kernel launched) against the fp32
     plain forward on the card; class agreement with the bf16 forward; one
     more fused forward under torch.profiler, as in 4;
  6. fp32 forward on the card against the CPU forward on a small tree (the
     CPU path is the one the tests hold against the JAX package);
  7. the skeleton stages on the card against the CPU on the small tree's
     branch points with their ground-truth medial vectors: outlier filter,
     cell reduction, KNN graph, components, SSSP, root distances, and
     Skeletonizer.forward as a whole;
  8. the whole pipeline on the bench tree (the default configuration but
     bf16 and the batch capacity cap): Pipeline.process_cloud into a
     temporary directory, one warm-up and one timed run; the slab kernel
     must have launched inside it, the skeleton must have branches, and the
     four PLYs must hold the counts the skeleton implies;
  9. the default configuration (fp32) on the small tree through Pipeline,
     the card against the CPU;
 10. grid KNN: on the bench tree's reduced medial points (K = 16, r = the
     largest connection radius) `grid_knn` against the brute-force `knn`,
     both on the card and both timed; then `nn_graph` on more than 400,000
     vertices (those points replicated at offsets, with a seeded jitter),
     which takes the grid route;
 11. training at full width: a synthetic corpus into a temporary directory,
     `train.main` with the default training configuration (planes
     8/16/32/64, capacity 98,304, 416^3 grid) for two epochs, then resumed
     for exactly one more; finite losses, a lower mean train loss in epoch 2
     than in epoch 1, the checkpoints on disk, and no launch of either
     forward-only hand kernel;
 12. a few train steps on the small tree (`fit_smoke`), the card against the
     CPU from one seed;
 13. train -> serve: phase 11's best weights through
     ModelInference(precision="bfloat16") on the validation tree; finite
     outputs, and the slab kernel must have launched;
 14. the input side and the transfers on the bench tree at bf16: the native
     host dedup against the numpy one on every block (equal results, both
     tilings timed); ModelInference.forward with compact_transfers=False,
     compact, and compact + culled (the default configuration), each timed
     at max_in_flight 1 and 2 (equal clouds) with the bytes it moved; culled
     against compact exact (non-medial rows exactly 0), compact against the
     full download at the JAX package's own bounds; the slab kernel must
     have launched in both compact modes, and both kernels in a culled
     forward with fused=True;
 15. several devices on the one card: the bench tree's bf16 forward over two
     replicas on cuda:0 (ModelInference(devices=["cuda:0", "cuda:0"]),
     culled and with the full download) must return the rows of the
     one-device forward and launch the slab kernel; then one spawned gloo
     world of two ranks, killed and failed after 120 s, runs fit_smoke on
     the card and on the CPU (held against each other, the ranks'
     parameters equal bit for bit) and in a one-rank NCCL group (held
     against phase 12); a `{"parallel": ...}` line.
Phases 4, 8, 9 and 13 run the default compact transfers (8 and 9 the culled
download of the default configuration); 5 and 6 `predict`, the full download.
Then one line {"kernels": [...]}, the forward times, one line each with the
pipeline's stage times, the grid KNN's, the training's, the transfers' and
the parallel phase's numbers, and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WEIGHTS = REPO / "smart_tree_tpu" / "weights" / "noble-elevator-58.npz"
BENCH_TREE = dict(seed=0, height=12.0, trunk_radius=0.25, points_per_m2=12000.0,
                  foliage_points=20000)
SMALL_TREE = dict(seed=3, height=2.0, trunk_radius=0.08, points_per_m2=3000.0,
                  foliage_points=300)
MAX_BATCH_CAPACITY = 262144
# H100 SXM published peaks (dense): device memory bytes/s, bf16 tensor-core
# FLOP/s, fp32 (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SLAB_ATOL = 2e-4   # bf16 operands on both sides: fp32 summation order only
FUSED_TOL = dict(rtol=1e-4, atol=1e-5)   # fp32 both sides
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)   # the tests' model tolerance
WEIGHT_RTOL = 1e-6                       # exactly recomputed KNN distances: 1 ulp
DIST_TOL = dict(rtol=1e-5, atol=1e-6)    # fp32 path sums, min-reduced in another order
GEOM_TOL = dict(rtol=1e-5, atol=1e-6)    # branch vertices are gathered medial points
# fp32 predictions differ between the card and the CPU within MODEL_TOL, which
# can move a medial point across a cell border: whole-pipeline skeletons are
# held to the same branch counts and to their total length
PIPELINE_LENGTH_RTOL = 1e-2
# grid KNN against the brute force: 1 ulp of the distance, plus 4 ulps of the
# largest coordinate (the brute force subtracts the box centre from both
# points first, which rounds each coordinate once more)
GRID_RTOL = 1e-6
GRID_COORD_ULPS = 4 * 1.2e-7
# the training corpus: trees of the bench tree's family, smaller. An epoch
# draws TRAIN_PASSES differently augmented 4 m crops of every train tree (the
# split lists each that often), so that three epochs are some forty steps: the
# norms' running statistics, which serving reads, move a tenth of the way a step
CORPUS_TREE = dict(height=10.0, trunk_radius=0.2, points_per_m2=8000.0, foliage_points=8000)
CORPUS_SPLIT = dict(train=12, validation=1, test=1)
TRAIN_PASSES = 4
# fp32 exp overflows past 88.72; a served medial vector may be non-finite only
# where the predicted log radius is up there (8 below, for the two forwards'
# rounding), never elsewhere
EXP_OVERFLOW_FROM = 80.0
FIT_SMOKE_FIRST_RTOL = 1e-4   # one step: fp32 summation order
FIT_SMOKE_RTOL = 1e-2         # six Adam steps amplify last-bit gradient differences


def log(msg: str) -> None:
    print(f"# {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def cuda_time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(rb, cin: int, cout: int, precision: str):
    """Least time (ms) for out[M,Cout] = gather(table by rb[M,K3]) @ W: the
    larger of bytes over memory rate (the rulebook, the table rows it names,
    the weights, each read once, the output written once; 4-byte elements)
    and this rulebook's operations (2 * valid entries * Cin * Cout) over the
    peak rate for the operand type."""
    m, k3 = rb.shape
    valid = rb[rb >= 0]
    rows_read = int(valid.unique().numel())
    bytes_ = 4 * (m * k3 + rows_read * cin + k3 * cin * cout + m * cout)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * valid.numel() * cin * cout / PEAK_FLOPS[precision] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_ms_in(torch, fn, needles):
    """Run fn once under torch.profiler; per needle, the summed device
    milliseconds and the call count of the kernels whose name contains it."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    found = {needle: [0.0, 0] for needle in needles}
    seen = 0.0
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue   # host-op rows repeat their kernels' time
        us = float(getattr(evt, "self_device_time_total",
                           getattr(evt, "self_cuda_time_total", 0.0)))
        seen += us
        for needle in needles:
            if needle in evt.key:
                found[needle][0] += us / 1e3
                found[needle][1] += evt.count
    if seen <= 0.0:
        raise AssertionError("torch.profiler recorded no device time")
    return found


def unet_convs(plan, planes):
    """Every 27-column conv of one SmartTree forward on `plan`:
    (name, rulebook, table level, Cin, Cout)."""
    out = []
    levels = len(planes)
    for lvl in range(levels):
        lv, c = plan.levels[lvl], planes[lvl]
        out += [(f"L{lvl}.Head.0", lv.subm_rb, lvl, c, c),
                (f"L{lvl}.Head.3", lv.subm_rb, lvl, c, c)]
        if lvl < levels - 1:
            c2 = planes[lvl + 1]
            out += [(f"L{lvl}.Encode", lv.down_rb, lvl, c, c2),
                    (f"L{lvl}.Decode", lv.up_rb, lvl + 1, c2, c),
                    (f"L{lvl}.Tail.0", lv.subm_rb, lvl, 2 * c, c),
                    (f"L{lvl}.Tail.3", lv.subm_rb, lvl, c, c)]
    return out


def skeleton_stages(torch, cloud, device):
    """Every stage of the skeletonizer's front and graph halves on `device`,
    with the default settings: a dict of numpy arrays."""
    from smart_tree_tpu_torch.graph import (build_neighbor_table, chain_shortcut_table,
                                            component_sizes, connected_components,
                                            sssp_multi, tree_distances)
    from smart_tree_tpu_torch.skeleton.filter import outlier_removal
    from smart_tree_tpu_torch.skeleton.graph import nn_graph
    from smart_tree_tpu_torch.skeleton.quantize import medial_reduce
    from smart_tree_tpu_torch.skeleton.skeletonize import _component_roots, _select_components

    def up(a):
        return torch.from_numpy(a.astype("float32")).to(device)

    k = 16
    pts, radii, xyz = up(cloud.medial_pts), up(cloud.radius), up(cloud.xyz)
    keep = outlier_removal(pts, radii, nb_points=8, min_radius=0.02)
    rep, n = medial_reduce(pts, xyz[:, 1], keep, 0.01)
    pts, radii, y = pts[rep], radii[rep], xyz[rep, 1]
    valid = torch.ones(n, dtype=torch.bool, device=device)
    graph = nn_graph(pts, radii.clamp_min(0.02), k=k, valid=valid)
    sct = chain_shortcut_table(graph.edges[:, 1].reshape(n, k), graph.weights.reshape(n, k),
                               graph.valid.reshape(n, k))
    table = build_neighbor_table(graph.edges, graph.weights, graph.valid, n, cap=4 * k)
    labels = connected_components(graph.edges, graph.valid, n, vertex_valid=valid,
                                  table=table, shortcut_tbl=sct)
    comp_ids = _select_components(component_sizes(labels, valid), 32, 64)
    roots = _component_roots(labels, valid, y, comp_ids)
    dist, preds = sssp_multi(graph.edges, graph.weights, graph.valid, roots, n,
                             shortcut_tbl=sct, table=table)
    hop = pts - pts[preds.clamp_min(0)]
    root_dist = tree_distances(preds, (hop * hop).sum(dim=1).sqrt(), n)
    out = dict(keep=keep, rep=rep, edges=graph.edges, edge_valid=graph.valid,
               weights=graph.weights, labels=labels, comp_ids=comp_ids, roots=roots,
               dist=dist, preds=preds, root_dist=root_dist)
    return {name: t.cpu().numpy() for name, t in out.items()}


def same_skeletons(np, got, ref, what, tol=None):
    """Equal skeleton and branch counts and parents; with `tol`, allclose
    branch xyz and radii as well."""
    if len(got.skeletons) != len(ref.skeletons):
        raise AssertionError(f"{what}: {len(got.skeletons)} skeletons against "
                             f"{len(ref.skeletons)}")
    for a, b in zip(got.skeletons, ref.skeletons):
        if len(a.branches) != len(b.branches):
            raise AssertionError(f"{what}: skeleton {a._id} has {len(a.branches)} branches "
                                 f"against {len(b.branches)}")
        if tol is None:
            continue
        for key, x in a.branches.items():
            y = b.branches[key]
            if x.parent_id != y.parent_id:
                raise AssertionError(f"{what}: branch {key} parent {x.parent_id} != {y.parent_id}")
            np.testing.assert_allclose(x.xyz, y.xyz, **tol, err_msg=f"{what} branch {key} xyz")
            np.testing.assert_allclose(x.radii, y.radii, **tol, err_msg=f"{what} branch {key} radii")


def skeleton_length(skeleton) -> float:
    return sum(s.length for s in skeleton.skeletons)


def transfer_phase(torch, np, cloud, card):
    """Phase 14 on the bench tree at bf16: the native host dedup against the
    numpy one on every block, and ModelInference.forward in its three
    transfer modes (full download, compact, compact + culled) held against
    each other, with bytes moved and seconds at max_in_flight 1 and 2; then
    the culled forward with fused=True. Returns the `transfers` line."""
    from smart_tree_tpu_torch.core import fused_conv, slab_conv
    from smart_tree_tpu_torch.data.dataset import BlockTiler, voxelize_host, voxelize_host_plain
    from smart_tree_tpu_torch.infer.inference import ModelInference
    from smart_tree_tpu_torch.scripts.profile_forward import NumpyTiler, tilings_agree
    from smart_tree_tpu_torch.utils.maths import cube_filter

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the host dedup: both tilings, then both dedups on every block's crop
    tiler, tiling_native_s = synced(lambda: BlockTiler(cloud, 0.01, 4.0, 0.4))
    plain, tiling_numpy_s = synced(lambda: NumpyTiler(cloud, 0.01, 4.0, 0.4))
    if not tilings_agree(tiler, plain):
        raise AssertionError("the native and the numpy tilings differ")
    xyz, rgb = np.asarray(cloud.xyz, np.float32), np.asarray(cloud.rgb, np.float32)
    native_s = numpy_s = 0.0
    for centre in tiler.block_centres:
        m = cube_filter(xyz, centre, 4.0 + 2 * 0.4)
        data = np.concatenate([xyz[m], rgb[m]], axis=1)
        got, dt = synced(lambda: voxelize_host(xyz[m], data, 0.01))
        native_s += dt
        ref, dt = synced(lambda: voxelize_host_plain(xyz[m], data, 0.01))
        numpy_s += dt
        if not all(np.array_equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"native dedup differs from numpy on the block at {centre}")

    def make(**kw):
        mi = ModelInference(WEIGHTS, batch_size=4, precision="bfloat16", **kw)
        mi.max_batch_capacity = min(mi.max_batch_capacity, MAX_BATCH_CAPACITY)
        return mi

    def counted_forward(mi):
        """(cloud, seconds, B1 launches, B2 launches, link bytes) of one forward."""
        mi.link_bytes.update(upload=0, download=0)
        slab_conv.slab_gather_conv.launches = 0
        fused_conv.fused_gather_gemm.launches = 0
        out, dt = synced(lambda: mi.forward(cloud))
        return (out, dt, slab_conv.slab_gather_conv.launches,
                fused_conv.fused_gather_gemm.launches, dict(mi.link_bytes))

    modes = {"full": make(compact_transfers=False), "compact": make(),
             "culled": make(medial_classes=[0])}
    outs, rows = {}, {}
    for name, mi in modes.items():
        mi.forward(cloud)  # warm-up
        by_window = []
        for k in (1, 2):
            mi.max_in_flight = k
            out, dt, slab_n, _, moved = counted_forward(mi)
            by_window.append(out)
            rows.setdefault(name, {})[f"forward_s_in_flight_{k}"] = dt
        rows[name].update(upload_bytes=moved["upload"], download_bytes=moved["download"],
                          slab_launches=slab_n, voxels=len(out))
        for f in ("xyz", "medial_vector", "class_l"):
            if not np.array_equal(getattr(by_window[0], f), getattr(by_window[1], f)):
                raise AssertionError(f"{name}: max_in_flight 1 and 2 give different {f}")
        if name != "full" and slab_n == 0:
            raise AssertionError(f"the {name} forward never launched the slab kernel")
        outs[name] = out
    full, compact, culled = outs["full"], outs["compact"], outs["culled"]
    for name in ("compact", "culled"):
        for f in ("xyz", "rgb"):
            if not np.array_equal(getattr(outs[name], f), getattr(full, f)):
                raise AssertionError(f"{name} forward: {f} differs from the full download's")
    # culled against compact: one program on the same inputs
    np.testing.assert_array_equal(culled.class_l, compact.class_l)
    branch = compact.class_l[:, 0] == 0
    np.testing.assert_array_equal(culled.medial_vector[branch], compact.medial_vector[branch])
    if not (culled.medial_vector[~branch] == 0).all():
        raise AssertionError("culled forward: a non-medial row has a medial vector")
    # compact against full: int8 against fp16 residuals on the way up, the
    # quantised payload on the way down; the JAX package's own bounds for
    # this pair (tests/test_compact_transfers.py): 99 % of the classes, a
    # median relative radius difference under 2 %
    agree = float((compact.class_l == full.class_l).mean())
    rf = np.linalg.norm(full.medial_vector, axis=1)
    rc = np.linalg.norm(compact.medial_vector, axis=1)
    rel = float(np.median(np.abs(rc - rf) / np.maximum(rf, 1e-3)))
    if agree < 0.99 or rel >= 0.02:
        raise AssertionError(f"compact vs full: class agreement {agree}, median rel radius {rel}")

    # the culled forward with fused=True: B1 on the tall convs, B2 on the rest
    fused = make(medial_classes=[0], fused=True)
    fused.forward(cloud)  # warm-up
    out_f, fused_s, slab_f, fused_n, _ = counted_forward(fused)
    if slab_f == 0 or fused_n == 0:
        raise AssertionError(f"culled fused forward: {slab_f} slab, {fused_n} fused launches")
    np.testing.assert_array_equal(out_f.xyz, culled.xyz)
    agree_fused = float((out_f.class_l == culled.class_l).mean())
    if agree_fused < 0.99:
        raise AssertionError(f"culled fused vs culled: class agreement {agree_fused}")
    result = {
        "card": card, "points": len(cloud), "blocks": len(tiler.blocks),
        "host_dedup": {"tiling_native_s": tiling_native_s, "tiling_numpy_s": tiling_numpy_s,
                       "dedup_native_s": native_s, "dedup_numpy_s": numpy_s},
        "modes": rows,
        "compact_vs_full": {"class_agreement": agree, "median_rel_radius": rel},
        "culled_branch_rows": int(branch.sum()),
        "culled_fused": {"forward_s": fused_s, "slab_launches": slab_f,
                         "fused_launches": fused_n, "class_agreement": agree_fused},
    }
    log(f"transfers: {result}")
    return result


def _dp_rank(rank, world, cloud, steps):
    """One rank of phase 15's data-parallel fit_smoke, in the gloo world
    spawn_world made: the steps on the card, the same steps on the CPU, and
    on rank 0 the steps again in a one-rank NCCL group. Each as (per-step
    losses, final state_dict) from every rank."""
    import torch
    import torch.distributed as dist

    from smart_tree_tpu_torch.train.train import fit_smoke

    torch.set_num_threads(4)
    out = {}
    for name, device, group in (("card_gloo_2", "cuda:0", dist.group.WORLD),
                                ("cpu_gloo_2", "cpu", dist.group.WORLD)):
        stats: dict = {}
        losses = fit_smoke(cloud, steps=steps, capacity=16384, device=device, group=group,
                           stats=stats)
        out[name] = (losses, stats["state"])
    nccl = dist.new_group([0], backend="nccl")  # every rank takes part in making it
    if rank == 0:
        stats = {}
        losses = fit_smoke(cloud, steps=steps, capacity=16384, device="cuda:0", group=nccl,
                           stats=stats)
        out["card_nccl_1"] = (losses, stats["state"])
    return out


def parallel_phase(torch, np, cloud, small_raw, fit_card, card):
    """Phase 15 on the one card: (a) the bench tree's bf16 forward over two
    replicas on cuda:0 against the single-device forward, culled and with
    the full download (equal rows; the slab kernel launched); (b) fit_smoke
    data-parallel on two gloo ranks on the card against the same two ranks on
    the CPU, and in a one-rank NCCL group against phase 12's one-device
    steps (one spawned world: each process takes seconds to start).
    Returns the `parallel` line and the slab launches of one two-replica
    culled forward."""
    from smart_tree_tpu_torch.core import slab_conv
    from smart_tree_tpu_torch.infer.inference import ModelInference
    from smart_tree_tpu_torch.parallel import spawn_world

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def canonical(c):
        rows = np.concatenate([c.xyz, c.rgb, c.medial_vector, c.class_l], axis=1)
        return rows[np.lexsort(rows.T)]

    result = {"card": card, "forward": {}}
    multi_launches = None
    for mode, kw in (("culled", dict(medial_classes=[0])),
                     ("full", dict(compact_transfers=False))):
        pair = {}
        for name, devices in (("one", ["cuda:0"]), ("two_replicas", ["cuda:0", "cuda:0"])):
            mi = ModelInference(WEIGHTS, batch_size=4, precision="bfloat16", devices=devices,
                                **kw)
            mi.max_batch_capacity = min(mi.max_batch_capacity, MAX_BATCH_CAPACITY)
            # no warm-up: phase 14 ran these batches in both modes (the time
            # of the two-replica forward includes copying the model twice)
            slab_conv.slab_gather_conv.launches = 0
            out, dt = synced(lambda: mi.forward(cloud))
            launches = slab_conv.slab_gather_conv.launches
            if launches == 0:
                raise AssertionError(f"{mode} forward on {devices}: no slab launch")
            pair[name] = out
            result["forward"][f"{mode}_{name}_s"] = dt
            result["forward"][f"{mode}_{name}_slab_launches"] = launches
        if len(pair["one"]) == 0:
            raise AssertionError(f"{mode} forward returned no voxel")
        if not np.array_equal(canonical(pair["two_replicas"]), canonical(pair["one"])):
            raise AssertionError(f"{mode}: the two-replica forward differs from the one-device "
                                 "forward")
        if mode == "culled":
            multi_launches = result["forward"]["culled_two_replicas_slab_launches"]
    result["forward"]["voxels"] = len(pair["one"])

    # (b) data-parallel steps, in one gloo world of two ranks with a hard limit
    steps = len(fit_card)
    with tempfile.TemporaryDirectory() as rdv:
        t0 = time.perf_counter()
        # spawn_world kills the ranks and raises after 120 s: a hang fails
        ranks = spawn_world(_dp_rank, 2, f"file://{rdv}/rendezvous", args=(small_raw, steps))
        result["dp_world_s"] = time.perf_counter() - t0
    dp = {}
    for name in ("card_gloo_2", "cpu_gloo_2", "card_nccl_1"):
        runs = [r[name] for r in ranks if name in r]
        if len(runs) != (1 if name == "card_nccl_1" else 2):
            raise AssertionError(f"{name}: {len(runs)} ranks answered")
        losses, state = runs[0]
        for other_losses, other_state in runs[1:]:
            if not np.array_equal(other_losses, losses):
                raise AssertionError(f"{name}: the ranks logged different losses")
            for k in state:
                if not np.array_equal(other_state[k], state[k]):
                    raise AssertionError(f"{name}: the ranks hold different {k}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{name}: fit_smoke does not learn: {losses}")
        dp[name] = {"ranks": len(runs), "losses": losses.tolist()}
    card2, cpu2 = (np.asarray(dp[k]["losses"]) for k in ("card_gloo_2", "cpu_gloo_2"))
    np.testing.assert_allclose(card2[0], cpu2[0], rtol=FIT_SMOKE_FIRST_RTOL)
    np.testing.assert_allclose(card2, cpu2, rtol=FIT_SMOKE_RTOL)
    nccl1 = np.asarray(dp["card_nccl_1"]["losses"])
    np.testing.assert_allclose(nccl1[0], fit_card[0], rtol=FIT_SMOKE_FIRST_RTOL)
    np.testing.assert_allclose(nccl1, fit_card, rtol=FIT_SMOKE_RTOL)
    result["dp"] = dp
    log(f"parallel: {result}")
    return result, multi_launches

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np

    from smart_tree_tpu_torch.core import fused_conv, kernels, slab_conv
    from smart_tree_tpu_torch.core.sparse_ops import ConvConfig
    from smart_tree_tpu_torch.data.augmentations import CentreCloud
    from smart_tree_tpu_torch.data.dataset import BlockTiler
    from smart_tree_tpu_torch.data.synthetic import generate_tree
    from smart_tree_tpu_torch.infer.inference import ModelInference

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 2. build
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.load()
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s: {lib_path.name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 3. kernels at the main path's shapes
    cloud, _ = generate_tree(**BENCH_TREE)
    cloud = CentreCloud()(cloud)
    mi16 = ModelInference(WEIGHTS, voxel_size=0.01, block_size=4.0, buffer_size=0.4,
                          batch_size=4, precision="bfloat16")
    mi16.max_batch_capacity = min(mi16.max_batch_capacity, MAX_BATCH_CAPACITY)
    batches = list(BlockTiler(cloud, 0.01, 4.0, 0.4).batches(
        4, max_capacity=mi16.max_batch_capacity))
    # every 27-column conv of every batch, on the plan the forward settles on
    # (overflow retries included): (name, rulebook, table rows, Cin, Cout,
    # the batch's slab row threshold)
    convs = []
    for vb in batches:
        level_caps = None
        while True:
            x, plan, _ = mi16._plan_batch(vb, level_caps)
            counts = [int(lv.count) for lv in plan.levels]
            caps = [lv.keys.shape[0] for lv in plan.levels]
            if all(c <= k for c, k in zip(counts, caps)):
                break
            level_caps = ModelInference._retry_caps(counts, caps)
        log(f"batch capacity {len(vb.coords)}: level capacities {caps}, counts {counts}")
        slab_min = ConvConfig("bfloat16", cap_hint=x.capacity).slab_min_rows
        convs += [(f"cap{len(vb.coords)}.{name}", rb, plan.levels[lvl].keys.shape[0],
                   cin, cout, slab_min)
                  for name, rb, lvl, cin, cout in unet_convs(plan, mi16.model.unet_planes)]
    log(f"{len(cloud)} points, {len(batches)} batches, {len(convs)} convs")
    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(rb, n, cin, cout):
        feats = torch.randn((n, cin), generator=gen, device=dev)
        w = torch.randn((27, cin, cout), generator=gen, device=dev) / (27 * cin) ** 0.5
        return feats, rb, w

    if kernels.load().st_slab_conv_tile() != slab_conv.TILE_ROWS:
        raise AssertionError("slab_conv.TILE_ROWS is not the built kernel's tile")

    def twice_equal(fn, what):
        """The kernel's result, after a second launch gave the same bits."""
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: two launches on one input differ")
        return a

    def sparsity(rb):
        """How full the rulebook is: share of valid entries, 128-row tiles,
        and the tiles that hold a valid entry at all."""
        valid = rb >= 0
        tiles = -(-rb.shape[0] // slab_conv.TILE_ROWS)
        rows = torch.zeros(tiles * slab_conv.TILE_ROWS, dtype=torch.bool, device=rb.device)
        rows[: rb.shape[0]] = valid.any(dim=1)
        return {"valid_share": float(valid.float().mean()), "tiles": tiles,
                "nonempty_tiles": int(rows.view(tiles, -1).any(dim=1).sum())}

    def tallest(select):
        """Per (Cin, Cout), the tallest rulebook among the convs selected."""
        best = {}
        for name, rb, n, cin, cout, slab_min in convs:
            if select(rb, cin, cout, slab_min):
                key = (cin, cout)
                if key not in best or rb.shape[0] > best[key][1].shape[0]:
                    best[key] = (name, rb, n)
        return sorted(best.items())

    # the slab kernel at each (Cin, Cout) it takes, at its tallest rulebook
    slab_rows_out = []
    for (cin, cout), (name, rb, n) in tallest(lambda rb, ci, co, smin: rb.shape[0] >= smin):
        feats, rb, w = operands(rb, n, cin, cout)
        got = twice_equal(lambda: slab_conv.slab_gather_conv(feats, rb, w), f"slab kernel {name}")
        ref = slab_conv.slab_gather_conv_plain(feats, rb, w)
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, rtol=0, atol=SLAB_ATOL):
            raise AssertionError(f"slab kernel {name} ({cin}->{cout}): max abs err {err}")
        out = torch.empty_like(got)
        scratch = slab_conv._scratch(w)
        n, m = feats.shape[0], rb.shape[0]
        fe16 = torch.cat([feats, feats.new_zeros((1, cin))]).to(torch.bfloat16)
        idx = torch.where(rb >= 0, rb, n).long()
        w16 = w.to(torch.bfloat16).reshape(27 * cin, cout)
        b_ms, b_by = bound(rb, cin, cout, "bfloat16")
        no_rb = torch.full_like(rb, -1)
        row = {
            "conv": name, "cin": cin, "cout": cout, "m": m, "n": n, **sparsity(rb),
            "max_abs_err": err,
            # the same launch on a rulebook without a valid entry: what reading
            # the rulebook and storing zeros costs
            "all_missing_kernel_ms": cuda_time_ms(torch, lambda: slab_conv._launch(
                feats, no_rb, w, scratch, out)),
            "ms": cuda_time_ms(torch, lambda: slab_conv.slab_gather_conv(feats, rb, w)),
            "kernel_ms": cuda_time_ms(torch, lambda: slab_conv._launch(feats, rb, w, scratch, out)),
            "plain_ms": cuda_time_ms(torch, lambda: slab_conv.slab_gather_conv_plain(feats, rb, w)),
            "library_ms": cuda_time_ms(torch, lambda: torch.matmul(fe16[idx].view(m, -1), w16)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        log(f"slab {name} {cin}->{cout} M={m}: {row}")
        slab_rows_out.append(row)
    if not slab_rows_out:
        raise AssertionError("no conv of the bench plan reaches the slab kernel")

    # the fused kernel at each (27, Cin, Cout) the fp32 fused=True forward gives
    # it (table <= 8 MiB), at its tallest rulebook
    fused_rows_out = []
    for (cin, cout), (name, rb, n) in tallest(
            lambda rb, ci, co, smin: fused_conv.should_use_fused(rb.shape[0], 27, ci, co)):
        feats, rb, w = operands(rb, n, cin, cout)
        got = twice_equal(lambda: fused_conv.fused_gather_gemm(feats, rb, w),
                          f"fused kernel {name}")
        ref = fused_conv.fused_gather_gemm_plain(feats, rb, w)
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, **FUSED_TOL):
            raise AssertionError(f"fused kernel {name} ({cin}->{cout}): max abs err {err}")
        n, m = feats.shape[0], rb.shape[0]
        fe = torch.cat([feats, feats.new_zeros((1, cin))])
        idx = torch.where(rb >= 0, rb, n).long()
        w2 = w.reshape(27 * cin, cout)
        out = torch.empty_like(got)
        b_ms, b_by = bound(rb, cin, cout, "float32")
        row = {
            "conv": name, "k3": 27, "cin": cin, "cout": cout, "m": m, "n": n,
            **sparsity(rb), "max_abs_err": err,
            "ms": cuda_time_ms(torch, lambda: fused_conv.fused_gather_gemm(feats, rb, w)),
            "kernel_ms": cuda_time_ms(torch, lambda: fused_conv._launch(feats, rb, w, out)),
            "plain_ms": cuda_time_ms(torch, lambda: fused_conv.fused_gather_gemm_plain(feats, rb, w)),
            "library_ms": cuda_time_ms(torch, lambda: torch.matmul(fe[idx].view(m, -1), w2)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        log(f"fused {name} {cin}->{cout} M={m}: {row}")
        fused_rows_out.append(row)
    if not fused_rows_out:
        raise AssertionError("no conv of the bench plan reaches the fused kernel")
    del x, plan, convs, feats, rb, no_rb, w, fe, fe16, idx, out, got, ref, scratch

    # 4. bf16 forward of the bench tree
    n_interior = sum(int(b.mask.sum()) for b in batches)
    mi16.forward(cloud)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slab_conv.slab_gather_conv.launches = 0
    fused_conv.fused_gather_gemm.launches = 0
    times16 = []
    for _ in range(3):
        t0 = time.perf_counter()
        out16 = mi16.forward(cloud)
        torch.cuda.synchronize()
        times16.append(time.perf_counter() - t0)
    slab_launches = slab_conv.slab_gather_conv.launches
    peak16 = torch.cuda.max_memory_allocated()
    if slab_launches == 0:
        raise AssertionError("the bf16 forward never launched the slab kernel")
    if len(out16.xyz) != n_interior:
        raise AssertionError(f"bf16 forward returned {len(out16.xyz)} points, "
                             f"expected {n_interior}")
    for k in ("xyz", "medial_vector", "class_l"):
        if not np.isfinite(getattr(out16, k)).all():
            raise AssertionError(f"bf16 forward: non-finite {k}")
    slab_conv.slab_gather_conv.launches = 0
    prof = kernel_ms_in(torch, lambda: mi16.forward(cloud),
                        ("slab_conv_kernel", "slab_weight_fragments"))
    slab_per_forward = slab_conv.slab_gather_conv.launches
    slab_forward_ms = sum(ms for ms, _ in prof.values())
    slab_fragment_ms = prof["slab_weight_fragments"][0]
    if prof["slab_conv_kernel"][1] != slab_per_forward:
        raise AssertionError(f"profiler saw {prof['slab_conv_kernel'][1]} slab kernels, "
                             f"the wrapper counted {slab_per_forward}")
    log(f"bf16 forwards {times16} s, slab launches {slab_launches}; in one forward "
        f"{slab_per_forward} launches, {slab_forward_ms:.3f} ms of device time "
        f"({prof['slab_weight_fragments'][0]:.3f} ms of it the weight-fragment kernel)")

    # 5. fp32 forward, fused kernel vs the plain gather + matmul
    mi32f = ModelInference(WEIGHTS, batch_size=4, precision="float32", fused=True)
    mi32 = ModelInference(WEIGHTS, batch_size=4, precision="float32")
    for mi in (mi32f, mi32):
        mi.max_batch_capacity = min(mi.max_batch_capacity, MAX_BATCH_CAPACITY)
        mi.predict(cloud)  # warm-up
    slab_conv.slab_gather_conv.launches = 0
    fused_conv.fused_gather_gemm.launches = 0
    t0 = time.perf_counter()
    out32f = mi32f.predict(cloud)
    torch.cuda.synchronize()
    time32f = time.perf_counter() - t0
    fused_launches = fused_conv.fused_gather_gemm.launches
    if fused_launches == 0:
        raise AssertionError("the fused fp32 forward never launched the fused kernel")
    t0 = time.perf_counter()
    out32 = mi32.predict(cloud)
    torch.cuda.synchronize()
    time32 = time.perf_counter() - t0
    np.testing.assert_array_equal(out32f["xyz"], out32["xyz"])
    np.testing.assert_allclose(out32f["radius"], out32["radius"], **MODEL_TOL)
    np.testing.assert_allclose(out32f["direction"], out32["direction"], **MODEL_TOL)
    cls32f = out32f["class_logits"].argmax(1)
    cls32 = out32["class_logits"].argmax(1)
    agree_fused = float((cls32f == cls32).mean())
    if agree_fused < 0.999:
        raise AssertionError(f"fused vs plain fp32 class agreement {agree_fused}")
    np.testing.assert_array_equal(out16.xyz, out32["xyz"])
    agree_bf16 = float((out16.class_l[:, 0] == cls32).mean())
    fused_conv.fused_gather_gemm.launches = 0
    prof = kernel_ms_in(torch, lambda: mi32f.predict(cloud), ("fused_conv_kernel",))
    fused_per_forward = fused_conv.fused_gather_gemm.launches
    fused_forward_ms, fused_seen = prof["fused_conv_kernel"]
    if fused_seen != fused_per_forward:
        raise AssertionError(f"profiler saw {fused_seen} fused kernels, "
                             f"the wrapper counted {fused_per_forward}")
    log(f"fp32 fused {time32f:.3f} s, plain {time32:.3f} s, fused launches {fused_launches}; "
        f"in one forward {fused_per_forward} launches, {fused_forward_ms:.3f} ms of device time")

    # 6. the card against the CPU path on a small tree
    small = CentreCloud()(generate_tree(**SMALL_TREE)[0])
    got = ModelInference(WEIGHTS, precision="float32").predict(small)
    ref = ModelInference(WEIGHTS, precision="float32", device="cpu").predict(small)
    np.testing.assert_array_equal(got["xyz"], ref["xyz"])
    for k in ("radius", "direction", "class_logits"):
        np.testing.assert_allclose(got[k], ref[k], **MODEL_TOL, err_msg=k)

    # 7. the skeleton stages, the card against the CPU
    from smart_tree_tpu_torch.data.file import ply_element_counts
    from smart_tree_tpu_torch.scripts.profile_pipeline import bench_pipeline, timed_run
    from smart_tree_tpu_torch.skeleton.skeletonize import Skeletonizer
    from smart_tree_tpu_torch.utils.configs import default_pipeline_config, instantiate

    small_raw = generate_tree(**SMALL_TREE)[0]
    small_branch = small_raw.filter_by_class([0])
    on_card = skeleton_stages(torch, small_branch, dev)
    on_cpu = skeleton_stages(torch, small_branch, torch.device("cpu"))
    for name in ("keep", "rep", "edges", "edge_valid", "labels", "comp_ids", "roots", "preds"):
        np.testing.assert_array_equal(on_card[name], on_cpu[name], err_msg=f"stage {name}")
    ev = on_cpu["edge_valid"]
    np.testing.assert_allclose(on_card["weights"][ev], on_cpu["weights"][ev], rtol=WEIGHT_RTOL,
                               err_msg="stage weights")
    for name in ("dist", "root_dist"):
        fin = np.isfinite(on_cpu[name])
        np.testing.assert_array_equal(np.isfinite(on_card[name]), fin, err_msg=f"stage {name}")
        np.testing.assert_allclose(on_card[name][fin], on_cpu[name][fin], **DIST_TOL,
                                   err_msg=f"stage {name}")
    sk_card = Skeletonizer().forward(small_branch)
    sk_cpu = Skeletonizer(device="cpu").forward(small_branch)
    if not sk_cpu.skeletons or len(sk_cpu.skeletons[0].branches) < 2:
        raise AssertionError("the small tree gave no skeleton on the CPU")
    same_skeletons(np, sk_card, sk_cpu, "Skeletonizer.forward card vs cpu", GEOM_TOL)
    log(f"skeleton stages agree: {int(on_cpu['keep'].sum())} kept of {len(small_branch)}, "
        f"{len(on_cpu['rep'])} vertices, {len(sk_cpu.skeletons[0].branches)} branches")

    # 8. the whole pipeline on the bench tree, bf16, PLYs into a temporary directory
    raw_cloud = generate_tree(**BENCH_TREE)[0]
    with tempfile.TemporaryDirectory() as out_dir:
        pipeline = bench_pipeline(out_dir)
        timed_run(pipeline, raw_cloud)  # warm-up (raises hop_cap if the strict check asks)
        slab_conv.slab_gather_conv.launches = 0
        fused_conv.fused_gather_gemm.launches = 0
        torch.cuda.reset_peak_memory_stats()
        pipe_stats, skeleton = timed_run(pipeline, raw_cloud)
        pipe_slab_launches = slab_conv.slab_gather_conv.launches
        pipe_stats["peak_bytes"] = torch.cuda.max_memory_allocated()
        if pipe_slab_launches == 0:
            raise AssertionError("the bf16 pipeline never launched the slab kernel")
        branches = [b for sk in skeleton.skeletons for b in sk.branches.values()]
        if not skeleton.skeletons or max(len(sk.branches) for sk in skeleton.skeletons) < 2:
            raise AssertionError("the pipeline gave no skeleton with two branches")
        for b in branches:
            if not (np.isfinite(b.xyz).all() and np.isfinite(b.radii).all()):
                raise AssertionError(f"branch {b._id}: non-finite geometry")
        drawn = [len(b) for b in branches if len(b) >= 2]
        expected = {
            "skeleton.ply": {"vertex": sum(drawn), "edge": sum(n - 1 for n in drawn)},
            "mesh.ply": {"vertex": 10 * sum(drawn), "face": 20 * sum(n - 1 for n in drawn)},
            "cloud.ply": {"vertex": n_interior},
            "seg_cld.ply": {"vertex": n_interior},
        }
        for name, counts in expected.items():
            found = ply_element_counts(Path(out_dir) / name)
            if found != counts:
                raise AssertionError(f"{name}: elements {found}, the skeleton implies {counts}")
            size = (Path(out_dir) / name).stat().st_size
            if size < 12 * counts["vertex"]:
                raise AssertionError(f"{name}: {size} bytes is short of its vertices")
    pipe_stats.update(card=card, points=len(raw_cloud), slab_launches=pipe_slab_launches,
                      skeleton_length_m=skeleton_length(skeleton),
                      ply_elements=expected)
    log(f"pipeline: {pipe_stats}")

    # 9. the default configuration (fp32) on the small tree, the card against the CPU
    skeletons9 = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for where in ("cuda", "cpu"):
            cfg = default_pipeline_config()
            cfg["model_inference"].update(weights_path=str(WEIGHTS), device=where)
            cfg["skeletonizer"]["device"] = where
            cfg["save_path"] = str(Path(out_dir) / where)
            skeletons9[where] = instantiate(cfg).process_cloud(cloud=small_raw)
            for name in ("skeleton.ply", "mesh.ply", "cloud.ply", "seg_cld.ply"):
                if not (Path(out_dir) / where / name).is_file():
                    raise AssertionError(f"default pipeline on {where}: {name} not written")
    same_skeletons(np, skeletons9["cuda"], skeletons9["cpu"], "default pipeline card vs cpu")
    len_card, len_cpu = (skeleton_length(skeletons9[w]) for w in ("cuda", "cpu"))
    if not len_cpu > 0 or abs(len_card - len_cpu) > PIPELINE_LENGTH_RTOL * len_cpu:
        raise AssertionError(f"default pipeline: skeleton length {len_card} m on the card, "
                             f"{len_cpu} m on the CPU")
    log(f"default pipeline card vs cpu: {len(skeletons9['cpu'].skeletons)} skeletons, "
        f"length {len_card:.4f} / {len_cpu:.4f} m")

    # 10. grid KNN against the brute force, and nn_graph past its threshold
    from smart_tree_tpu_torch.neighbors import grid_knn, knn
    from smart_tree_tpu_torch.skeleton import graph as graph_mod
    from smart_tree_tpu_torch.skeleton.filter import outlier_removal
    from smart_tree_tpu_torch.skeleton.quantize import medial_reduce

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    branch16 = out16.filter_by_class([0])
    mp, mr, my = up(branch16.medial_pts), up(branch16.radius), up(branch16.xyz[:, 1])
    keep = outlier_removal(mp, mr, nb_points=8, min_radius=0.02)
    rep, _ = medial_reduce(mp, my, keep, 0.01)
    mp, mr = mp[rep], mr[rep].clamp_min(0.02)
    r_max = float(mr.max())
    k = 16

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    grid_knn(mp[:4096], mp, k, r_max)  # warm-up of both at a few rows
    knn(mp[:4096], mp, k, r_max)
    _, grid_s = timed(lambda: grid_knn(mp, mp, k, r_max))
    _, brute_s = timed(lambda: knn(mp, mp, k, r_max))
    # held at K + 1, so that a tie between the K-th neighbour and the first
    # one left out shows as a tie too
    gd, gi = grid_knn(mp, mp, k + 1, r_max)
    bd, bi = knn(mp, mp, k + 1, r_max)
    hit = bi >= 0
    if not torch.equal(gi >= 0, hit):
        raise AssertionError("grid_knn and knn disagree on which neighbours exist")
    coord = float(mp.abs().max())
    gap = (gd[hit] - bd[hit]).abs()
    if bool((gap > GRID_RTOL * bd[hit] + GRID_COORD_ULPS * coord).any()):
        raise AssertionError(f"grid_knn distances off by up to {float(gap.max())}")
    # rows whose distances are all different (by more than twice what the two
    # methods may disagree by) must name the same neighbours
    slack = 2 * (GRID_RTOL * bd[:, 1:] + GRID_COORD_ULPS * coord)
    tied = ((bd[:, 1:] - bd[:, :-1]).abs() <= slack) & hit[:, 1:]
    clean = ~tied.any(dim=1)
    wrong = int((gi[clean, :k] != bi[clean, :k]).any(dim=1).sum())
    if wrong or int(clean.sum()) < mp.shape[0] // 2:
        raise AssertionError(f"grid_knn and knn name different neighbours on {wrong} of "
                             f"{int(clean.sum())} rows without ties")
    # past the threshold: the same points at five offsets, jittered from a seed
    jit = torch.Generator(device=dev).manual_seed(10)
    copies = -(-(graph_mod.GRID_KNN_THRESHOLD + 1) // mp.shape[0])
    shifts = torch.arange(copies, device=dev, dtype=torch.float32)[:, None, None] * \
        torch.tensor([30.0, 0.0, 0.0], device=dev)
    big = (mp[None] + shifts).reshape(-1, 3)
    big = big + (torch.rand(big.shape, generator=jit, device=dev) - 0.5) * 2e-3
    big_r = mr.repeat(copies)
    if big.shape[0] <= graph_mod.GRID_KNN_THRESHOLD:
        raise AssertionError("the replicated cloud is not past the grid KNN threshold")
    torch.cuda.reset_peak_memory_stats()
    big_graph, big_s = timed(lambda: graph_mod.nn_graph(big, big_r, k=k))
    big_peak = torch.cuda.max_memory_allocated()
    degree = big_graph.valid.view(-1, k).sum(dim=1)
    if int(degree.min()) < 1 or not bool(torch.isfinite(big_graph.weights[big_graph.valid]).all()):
        raise AssertionError("nn_graph past the threshold: a vertex without its own edge")
    # no edge may cross between the copies, 30 m apart
    src_copy = big_graph.edges[:, 0] // mp.shape[0]
    dst_copy = big_graph.edges[:, 1] // mp.shape[0]
    if bool((big_graph.valid & (src_copy != dst_copy)).any()):
        raise AssertionError("nn_graph past the threshold: an edge between two copies")
    grid_stats = {
        "card": card, "vertices": int(mp.shape[0]), "k": k, "r": r_max,
        "grid_knn_s": grid_s, "knn_s": brute_s,
        "rows_without_ties": int(clean.sum()), "max_abs_dist_gap": float(gap.max()),
        "big_vertices": int(big.shape[0]), "big_nn_graph_s": big_s,
        "big_peak_bytes": big_peak, "big_mean_degree": float(degree.float().mean()),
    }
    log(f"grid knn: {grid_stats}")
    del big, big_r, big_graph, gd, gi, bd, bi, src_copy, dst_copy, degree

    # 11. training at full width, through the entry point
    from smart_tree_tpu_torch.data.file import save_data_npz
    from smart_tree_tpu_torch.train import train as train_mod
    from smart_tree_tpu_torch.utils.configs import DEFAULT_TRAINING

    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        split, seed = {}, 100
        for part, count in CORPUS_SPLIT.items():
            split[part] = []
            for _ in range(count):
                tree_cloud, tree_skel = generate_tree(seed=seed, **CORPUS_TREE)
                split[part].append(f"tree_{seed}.npz")
                save_data_npz(str(work / split[part][-1]), tree_skel, tree_cloud)
                seed += 1
        split["train"] = split["train"] * TRAIN_PASSES
        (work / "split.json").write_text(json.dumps(split))
        argv = [f"directory={work}", f"json_path={work / 'split.json'}",
                f"output_dir={work / 'runs'}", "capture_output=0"]
        slab_conv.slab_gather_conv.launches = 0
        fused_conv.fused_gather_gemm.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        train_stats: dict = {}
        t0 = time.perf_counter()
        if train_mod.main(argv + ["num_epoch=2"], stats=train_stats) != 0:
            raise AssertionError("train.main returned non-zero")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated()
        epochs = train_stats["epochs"]
        if [e["epoch"] for e in epochs] != [0, 1]:
            raise AssertionError(f"training ran epochs {[e['epoch'] for e in epochs]}")
        for e in epochs:
            for phase in ("train", "val", "test"):
                if not (e[phase]["steps"] > 0 and np.isfinite(e[phase]["total_loss"])):
                    raise AssertionError(f"epoch {e['epoch']} {phase}: {e[phase]}")
        if not epochs[1]["train"]["total_loss"] < epochs[0]["train"]["total_loss"]:
            raise AssertionError("the mean train loss did not fall from epoch 1 to epoch 2: "
                                 f"{[e['train']['total_loss'] for e in epochs]}")
        run_dir = Path(train_stats["out_dir"])
        for name in ("best_weights.npz", "variables.npz", "train_state.pkl",
                     "last/variables.npz", "last/train_state.pkl"):
            if not (run_dir / name).is_file():
                raise AssertionError(f"training left no {name}")
        resumed: dict = {}
        if train_mod.main(argv + ["num_epoch=3", f"resume={run_dir / 'last'}"],
                          stats=resumed) != 0:
            raise AssertionError("the resumed train.main returned non-zero")
        if [e["epoch"] for e in resumed["epochs"]] != [2]:
            raise AssertionError("resume did not run exactly one more epoch: "
                                 f"{[e['epoch'] for e in resumed['epochs']]}")
        if not np.isfinite(resumed["epochs"][0]["train"]["total_loss"]):
            raise AssertionError("the resumed epoch's loss is not finite")
        if slab_conv.slab_gather_conv.launches or fused_conv.fused_gather_gemm.launches:
            raise AssertionError("a forward-only hand kernel was launched during training")
        steps = [e["train"] for e in epochs]
        timed_steps = sum(t["steps"] - 1 for t in steps)
        if timed_steps < 1:
            raise AssertionError("an epoch of one step: nothing to time after the first")
        step_s = sum(t["step_s"] * (t["steps"] - 1) for t in steps if t["step_s"]) / timed_steps
        training = {
            "card": card,
            "planes": DEFAULT_TRAINING["model"]["unet_planes"],
            "batch_capacity": DEFAULT_TRAINING["batch_capacity"],
            "spatial_shape": DEFAULT_TRAINING["spatial_shape"],
            "trees": CORPUS_SPLIT, "train_passes": TRAIN_PASSES, "epochs": 2,
            "steps": sum(t["steps"] for t in steps),
            "voxels_per_step": sum(t["voxels"] for t in steps) / sum(t["steps"] for t in steps),
            "step_s": step_s,
            "voxels_per_s": sum(t["voxels"] for t in steps) / sum(t["steps"] for t in steps)
            / step_s,
            # the whole train epochs on the host's clock, the first step of each
            # (which waits for a window of items to be made) included
            "epoch_voxels_per_s": sum(t["voxels"] for t in steps)
            / sum(t["fetch_s"] + t["dispatch_s"] + t["device_wait_s"] for t in steps),
            "fetch_s": sum(t["fetch_s"] for t in steps),
            "dispatch_s": sum(t["dispatch_s"] for t in steps),
            "device_wait_s": sum(t["device_wait_s"] for t in steps),
            "eval_steps": sum(e[p]["steps"] for e in epochs for p in ("val", "test")),
            "train_loss_by_epoch": [e["train"]["total_loss"] for e in epochs]
            + [resumed["epochs"][0]["train"]["total_loss"]],
            "val_loss_by_epoch": [e["val"]["total_loss"] for e in epochs]
            + [resumed["epochs"][0]["val"]["total_loss"]],
            "two_epochs_s": train_s, "peak_bytes": train_peak,
        }
        log(f"training: {training}")

        # 13. train -> serve (before the temporary directory goes): the best
        # weights in the bf16 server on the validation tree
        from smart_tree_tpu_torch.data.file import load_data_npz

        val_cloud = CentreCloud()(load_data_npz(work / split["validation"][0])[0])
        served = ModelInference(run_dir / "best_weights.npz", precision="bfloat16")
        served.max_batch_capacity = min(served.max_batch_capacity, MAX_BATCH_CAPACITY)
        slab_conv.slab_gather_conv.launches = 0
        # forward() returns exp(log radius) * direction. After some 40 steps at
        # lr 0.01 the running statistics still lag the weights, and on some
        # runs a few voxels' log radius passes 88, where fp32 exp gives inf.
        # That is these weights' doing, not the server's: what the network
        # puts out must be finite, the rows that exp overflows are counted.
        with np.errstate(over="ignore", invalid="ignore"):
            out_served = served.forward(val_cloud)
        torch.cuda.synchronize()
        served_launches = slab_conv.slab_gather_conv.launches
        if served_launches == 0:
            raise AssertionError("serving the trained weights never launched the slab kernel")
        if len(out_served) == 0:
            raise AssertionError("serving the trained weights returned no voxel")
        for name in ("xyz", "class_l"):
            if not np.isfinite(getattr(out_served, name)).all():
                raise AssertionError(f"serving the trained weights: non-finite {name}")
        raw_served = served.predict(val_cloud)
        for name in ("radius", "direction", "class_logits"):
            if raw_served[name].shape[0] != len(out_served) or \
                    not np.isfinite(raw_served[name]).all():
                raise AssertionError(f"serving the trained weights: non-finite {name}")
        overflowed = ~np.isfinite(out_served.medial_vector).all(axis=1)
        exp_overflows = int(overflowed.sum())
        if (raw_served["radius"][overflowed, 0] < EXP_OVERFLOW_FROM).any():
            raise AssertionError("serving the trained weights: a non-finite medial vector "
                                 "at a log radius that fp32 exp can hold")
        training.update(served_points=len(val_cloud), served_voxels=len(out_served),
                        served_slab_launches=served_launches,
                        served_feature_mode=served.feature_mode,
                        served_log_radius_max=float(raw_served["radius"].max()),
                        served_exp_overflows=exp_overflows)

    # 12. a few train steps on the small tree, the card against the CPU
    fit_card = train_mod.fit_smoke(small_raw, steps=6, capacity=16384)
    fit_cpu = train_mod.fit_smoke(small_raw, steps=6, capacity=16384, device="cpu")
    if not (np.isfinite(fit_card).all() and fit_card[-1] < fit_card[0]):
        raise AssertionError(f"fit_smoke on the card does not learn: {fit_card}")
    np.testing.assert_allclose(fit_card[0], fit_cpu[0], rtol=FIT_SMOKE_FIRST_RTOL)
    np.testing.assert_allclose(fit_card, fit_cpu, rtol=FIT_SMOKE_RTOL)
    training.update(fit_smoke_card=fit_card.tolist(), fit_smoke_cpu=fit_cpu.tolist())
    log(f"fit_smoke card {fit_card} cpu {fit_cpu}")

    # 14. the input side and the transfer paths on the bench tree, bf16
    transfers = transfer_phase(torch, np, cloud, card)

    # 15. several devices on the one card: replicas and ranks
    t0 = time.perf_counter()
    parallel, multi_launches = parallel_phase(torch, np, cloud, small_raw, fit_card, card)
    parallel["phase_s"] = time.perf_counter() - t0

    def summed(rows, key):
        return sum(r[key] for r in rows)

    def entry(rows, **head):
        """One kernel's line: one call at each shape the main path gives it,
        summed; per-shape rows under "shapes"."""
        return {
            **head,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": summed(rows, "ms"),
            "kernel_ms": summed(rows, "kernel_ms"),
            "plain_ms": summed(rows, "plain_ms"),
            "bound_ms": summed(rows, "bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
            else "operations",
            "library_ms": summed(rows, "library_ms"),
            "shapes": rows,
        }

    culled_launches = transfers["culled_fused"]
    entries = [
        entry(slab_rows_out,
              name="slab_gather_conv", route="cuda",
              source="smart_tree_tpu_torch/csrc/slab_conv.cu",
              replaces="smart_tree_tpu/core/pallas_slab.py:269",
              launches=slab_launches, launches_per_forward=slab_per_forward,
              launches_per_culled_forward=transfers["modes"]["culled"]["slab_launches"],
              launches_per_multi_device_forward=multi_launches,
              forward_kernel_ms=slab_forward_ms,
              forward_fragment_ms=slab_fragment_ms),
        entry(fused_rows_out,
              name="fused_gather_gemm", route="cuda",
              source="smart_tree_tpu_torch/csrc/fused_conv.cu",
              replaces="smart_tree_tpu/core/pallas_ops.py:86",
              launches=fused_launches, launches_per_forward=fused_per_forward,
              launches_per_culled_fused_forward=culled_launches["fused_launches"],
              forward_kernel_ms=fused_forward_ms),
    ]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({
        "card": card,
        "build_s": build_s,
        "points": len(cloud),
        "batches": len(batches),
        "interior_voxels": n_interior,
        "bf16_forward_s": times16,
        "bf16_points_per_s": len(cloud) / (sum(times16) / len(times16)),
        "bf16_peak_bytes": peak16,
        "fp32_fused_forward_s": time32f,
        "fp32_plain_forward_s": time32,
        "class_agreement_fused_vs_plain_fp32": agree_fused,
        "class_agreement_bf16_vs_fp32": agree_bf16,
    }), flush=True)
    print(json.dumps({"pipeline": pipe_stats}), flush=True)
    print(json.dumps({"grid_knn": grid_stats}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"transfers": transfers}), flush=True)
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
