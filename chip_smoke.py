#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (smart_tree_tpu_torch) on one
NVIDIA card (written for the H100, sm_90a).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
     TF32 off;
  3. kernels: (a) on the exact plans of the bench tree's batches, hold the
     slab kernel against its plain version at every (Cin, Cout) the bf16
     forward gives it, and the fused kernel at every (K3, Cin, Cout) the
     fp32 fused=True forward gives it, each at its tallest rulebook; launch
     each twice on one input and require equal bits; time each with CUDA
     events (through the wrapper, `ms`, and as the bare launch,
     `kernel_ms`) beside the plain version, the gather + torch.matmul
     composition (library_ms) and the least time the card could take; (b)
     the dispatch crossover (`dispatch_crossover`): at each (Cin, Cout), the
     tallest rulebook tiled to every row count of CROSSOVER_ROWS (37 to the
     card's largest batch, ragged ones among them), B1 against route 3 at
     bf16 and B2 against route 3 at fp32 (tables to 4x the TPU's 8 MiB),
     medians of 20 event-timed calls after 3 warm-ups, each kernel held
     against its plain version at every count; a `{"dispatch": ...}` line
     (the row thresholds of core/sparse_ops.py and core/fused_conv.py are
     set from it);
  4. bf16 forward of the bench tree (generate_tree seed 0, 12 m,
     noble-elevator-58, batches sized by ModelInference, one exact plan a
     batch): one warm-up, counts
     reset, three timed forwards; the slab kernel must have launched; then
     one more forward under torch.profiler for the slab kernel's summed
     device time and launches inside one forward;
  5. fp32 forward with fused=True (fused kernel launched) against the fp32
     plain forward on the card; class agreement with the bf16 forward; one
     more fused forward under torch.profiler, as in 4;
  6. fp32 forward on the card against the CPU forward on a small tree (the
     CPU path is the one the tests hold against the JAX package);
  7. the skeleton stages on the card against the CPU on the small tree's
     branch points with their ground-truth medial vectors: outlier filter
     (on the card through the count kernel), cell reduction, KNN graph,
     components, SSSP, root distances, and Skeletonizer.forward as a whole;
  8. the whole pipeline on the bench tree (the default configuration but
     bf16): Pipeline.process_cloud into a
     temporary directory, one warm-up and one timed run; the slab kernel
     and the outlier filter's count kernel must have launched inside it,
     the skeleton must have branches, and the four PLYs must hold the
     counts the skeleton implies;
  9. the default configuration (fp32) on the small tree through Pipeline,
     the card against the CPU;
 10. grid KNN: on the bench tree's reduced medial points (K = 16, r = the
     largest connection radius) `grid_knn` against the brute-force `knn`,
     both on the card and both timed; both on 4,096 seeded query rows
     against a float64 host recompute of their pairs (`exact_knn`, the
     bound of tests/test_torch_knn_exact.py); then `nn_graph` on more than 400,000
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
     tilings timed); the full download (`predict`, its medial vectors made
     on the host: `predicted`) and ModelInference.forward without and with
     the download cull to class 0 (the default configuration), each timed
     at max_in_flight 1 and 2 (equal clouds) with the bytes it moved; culled
     against compact exact (non-medial rows exactly 0), compact against the
     full download at the JAX package's own bounds; the slab kernel must
     have launched in both forwards; a culled fp32 forward with
     fused=True must launch the fused kernel alone and agree with the plain
     culled fp32 forward (at bf16 the slab kernel, faster at every row
     count, takes every 27-column conv before the fused kernel's route);
 15. several devices on the one card: the bench tree's bf16 forward over two
     replicas on cuda:0 (ModelInference(devices=["cuda:0", "cuda:0"]),
     culled and with the full download of `predicted`) must return the
     rows of the one-device forward and launch the slab kernel; then one
     spawned gloo world of two ranks, killed and failed after 120 s, runs
     fit_smoke on the card and on the CPU (held against each other, the
     ranks' parameters equal bit for bit) and in a one-rank NCCL group
     (held against phase 12); a `{"parallel": ...}` line;
 16. the modules ported last: (a) on the bench tree's batches (the exact
     plans the bf16 forward runs) the sorted-lookup `strided_rulebook` and
     `inverse_rulebook` equal the plan's strided and inverse rulebooks entry
     for entry, and `subm_rulebook9` on the card equals the CPU's; (b) every
     subm conv of one fp32 forward on z9 plans (build_plan(subm_mode="z9"))
     equals the full-rulebook route-3 conv on its inputs; (c) SmartTree on
     the z9 plans against the full plans: fp32 within the model tolerance,
     at bf16 each subm conv against the slab kernel on the full rulebook
     (FP32_UNIT's summation bound) and the whole forward within
     Z9_SPREAD_FACTOR of the full plan's own kernel spread; the slab kernel
     launched by the
     z9 bf16 forward exactly for its strided and inverse convs (never for a
     subm conv); both plans' forwards timed at both
     precisions (CUDA events, median of 5 after a warm-up); (d)
     connect_skeletons on phase 8's skeletons (at the default 0.5 m and at
     any distance, which grafts them all), sssp from one root and
     sample_tree on phase 7's small tree, each the card against the CPU;
     (e) viewer_items on the bench cloud and skeleton against phase 8's PLY
     counts, view_skeleton returning after its warning, and split_data plus
     one bench_dataloader epoch on phase 11's corpus (run while the corpus
     exists, at the end of phase 13); a `{"remaining_modules": ...}` line.
 17. the user tools (smart_tree_tpu_torch/tools/) through their entry
     points: (a) make_synthetic_dataset --per-family 1 at its default
     densities into a temporary directory, every file loaded and voxelised by
     the trainer's TreeDataset; (b) convert_checkpoint on the shipped
     noble-elevator-58 written as a reference .pt: the npz it writes equals
     the shipped one; (c) evaluate_tree with synthetic-r3 on seeds 100, 102
     and 103 at fp32 and at bf16 (every metric finite, a skeleton found, the
     slab kernel launched in the bf16 runs; seed 100 at fp32 equal to the
     CPU port's within the tests' 1e-4 and branch count), printed beside
     BASELINE.md's JAX CPU fp32 values, and noble-elevator-58 on seed 100 at
     both precisions; diagnose_direction (seed 100) and diagnose_e2e
     (synthetic-r2) on the card; (d) the forest scan at bench_scan's
     defaults (6 trees, 8,000 points/m^2, bf16) with
     the skeleton stage: one warm-up and one timed forward, the slab kernel
     and the filter's count kernel launched, finite outputs, at least one skeleton and 6 branches, every
     skeleton point inside the scan's bounds +-1 m; stage seconds, graph
     vertices, KNN route and peak memory; `knn` and `grid_knn` on the
     forest's reduced medial points held against float64 as in phase 10;
     a `{"tools": ...}` line.
 18. the training probes (smart_tree_tpu_torch/tools/{overfit_probe,
     cpu_probe}.py) at the JAX tools' defaults, logged every 25 steps: (a)
     the overfit probe on its seed-0 tree (capacity 65,536, planes
     8/16/32/64, xyz features, cosine loss) for 400 steps at lr 0.05 and at
     lr 0.01, and for 200 at lr 0.01 with --fp16; (b) cpu_probe for 400
     steps with --aug full, then --aug none; (c) the first 3 steps of (a)
     at lr 0.01 and of (b) full again on the CPU from the same seeded
     weights: step 0 within rtol 1e-4, steps 1-2 within 2e-2; (d) no launch of either hand kernel in the card's probe steps;
     (e) every loss finite, and the lr 0.01 fp32 direction loss at the last
     step below its step-0 value (lr 0.05 and bf16 are reported, not held);
     (f) per run the logged curve, the median seconds a step after 5
     warm-up steps, peak device bytes and seconds; a `{"probes": ...}` line,
     printed before a failed check fails the script;
 19. the port's bench (smart_tree_tpu_torch/bench.py): (a) `python -m
     smart_tree_tpu_torch.bench` at its shipped defaults as a subprocess,
     its last line held to rc 0, no `error` or `skeleton_error`, value,
     device_step_s, clouds_per_min_e2e and slab_launches_per_forward above
     0, and the bench tree's 356,709 points; (b) the supervisor with `--tiny
     --fault raise`: a non-zero exit and one JSON line carrying `error`; (c)
     the roofline (smart_tree_tpu_torch/tools/roofline.py) of (a)'s batches'
     exact level rows: the forward's FLOPs and bytes and their shares of the
     card's peaks at (a)'s device time, printed, not gated; a `{"bench": ...}`
     line.
 20. the batch sizing at the card's budget (core/memory.py): (a) the card's
     total memory, the budget (0.75 of it) and ModelInference's largest batch
     capacity at max_in_flight 1 and 2, fp32 and bf16; (b) at every pow2
     capacity from 65,536 to that largest one, a batch of four synthetic
     blocks (SIZING_*) in each layout, dense layers and random voxels,
     through the culled forward at fp32 and bf16; then at fp32 and bf16 the
     bench tree's batches and the forest's densest blocks' batches alone,
     one UNet pass each; then random blocks under a budget sized for their
     batch, which their exact plan passes, so that the batch splits before
     it runs. In each, splits included, the peak bytes allocated must not
     pass the footprint model with the card's terms before its 1.5x headroom
     at the exact level rows of the largest plan run (their ratio is
     printed), every pass's model as the plan charges it must fit the
     budget, and at the largest capacity every route-3 gather of the layers
     must chunk as ConvConfig.chunked says; (c) a cloud of two layered
     batches at the largest capacity with two in flight, within the budget
     and the model; (d) the slab kernel on level 0 of the largest batch at
     each (Cin, Cout) it takes there, against its plain version at SLAB_ATOL
     and timed as in 3; (e) the card's plan against the old 262,144
     ceiling: the same batches on the bench tree and the forest's first 16
     blocks (no forward), and on four dense blocks that the old ceiling
     splits into four batches fp32 predictions within MODEL_TOL, with the
     class agreement; a `{"sizing": ...}` line.
 21. exact plans (`exact_plan_phase`): (a) the bench tree at bf16 through
     the full download (`predicted`) and the forward without and with the
     cull: one UNet pass a batch, every plan tensor at its level's exact
     count (`checked_unet`), B1 launches a forward, seconds (median of 5), the device-busy share of one profiled
     forward, the peak allocated bytes held against the footprint model at
     the exact counts; (b) at fp32 each bench batch's exact plan against
     static plans at capacities that do not overflow (the trainer's form),
     route 3 on every conv, within MODEL_TOL; (c) the bf16 classes against
     fp32's (at least 99 % equal); (d) fp32 card against CPU on the small
     tree; (e) the forest's densest blocks, one pass a batch, beside phase
     17's whole forest scan (its passes a forward equal its batches); an
     `{"exact_plans": ...}` line;
 22. the outlier filter's count (`radius_count_phase`): on the branch points
     of phase 10's bench-tree forward and of phase 17's forest scan, radii
     clamped at 0.02 m as the skeletonizer clamps them, the count kernel
     (csrc/radius_count.cu) launched twice and its plain version on the
     card, equal int32 bits; the shell it leaves and `_exact_keep` on it;
     the wrapper, the bare kernel, the plain version and the whole filter
     timed by CUDA events beside the bound; the count on cells of the
     largest reach (equal counts, its time); on the bench tree also the JAX
     formulation the filter used before (`knn.radius_count`), its shell
     and its `_exact_keep`; a `{"radius_count": ...}` line;
 23. the branch tracer (`tracer_phase`): on the inputs phase 8's timed run
     gave `sample_forest` (phase 8 requires the tracer's launches), the
     greedy loop with the kernels of csrc/tracer.cu and with the plain step,
     both on the card, equal state bit for bit; the wrapper, the kernels'
     device time, the plain step and the bound, each a greedy iteration (the
     tracer's row of the kernels line);
 24. the forward's device tiler (`tiler_phase`): on the bench tree and the
     forest, the kernels of csrc/tiler.cu against the plain version and
     against the host tiler with its key order and staging, bit for bit;
     wall, kernel, host-yardstick, plain and bound ms a cloud, launches and
     host reads; the bench tree's forward must launch them (the tiler's row
     of the kernels line and a `{"tiler": ...}` line).
Phases 4, 8, 9 and 13 run the forward (8 and 9 with the download cull of
the default configuration); 5 and 6 `predict`, the full download.
Then one line {"kernels": [...]}, the forward times, one line each with the
pipeline's stage times, the grid KNN's, the training's, the transfers', the
parallel phase's, the last modules', the tools', the probes', the bench's,
the sizing's, the dispatch crossover's, the exact plans' and the radius
count's numbers, and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
# H100 SXM published peaks (dense): device memory bytes/s, bf16 tensor-core
# FLOP/s, fp32 (non-tensor-core) FLOP/s
from smart_tree_tpu_torch.tools import roofline  # noqa: E402
from smart_tree_tpu_torch.tools.roofline import HBM_BYTES_PER_S, PEAK_FLOPS  # noqa: E402

WEIGHTS = REPO / "smart_tree_tpu" / "weights" / "noble-elevator-58.npz"
BENCH_TREE = dict(seed=0, height=12.0, trunk_radius=0.25, points_per_m2=12000.0,
                  foliage_points=20000)
SMALL_TREE = dict(seed=3, height=2.0, trunk_radius=0.08, points_per_m2=3000.0,
                  foliage_points=300)
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
# knn and grid_knn against a float64 host recompute of the pairs they return,
# on a seeded sample of query rows (tests/test_torch_knn_exact.py's bound): 2
# fp32 ulps of the distance, plus for the centred brute force 2 ulps of the
# largest coordinate
EXACT_ROWS = 4096
EXACT_RTOL = 2.4e-7
# the forest's check runs at a fixed 10 cm radius: the skeleton stage's own
# (its largest predicted radius) would only make the grid's cells crowded
FOREST_EXACT_R = 0.1
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
# z9 subm convs against the slab kernel on the full rulebook at bf16: both sum
# the same exact fp32 products (bf16 x bf16) of a row, K = 27 * Cin of them, in
# other orders, so they differ by at most 2 (K - 1) 2^-24 sum_k |x_k w_k| (the
# classical bound for recursive summation, on each side), plus SLAB_ATOL. The
# bench tree's activations reach 1e10 (noble-elevator-58's norms), where
# SLAB_ATOL alone, set at unit scale, says nothing
FP32_UNIT = 2.0 ** -24
# z9 against full plans at bf16, whole forward: the per-conv differences above
# flip bf16 roundings of later operands, and the network amplifies them. The
# yardstick is the full plan itself: its bf16 forward with every conv through
# route 3 differs from the one with the slab kernel by summation order alone.
# The z9 forward (route 3 on the subm convs, the slab kernel on the rest) must
# stay within twice that spread of the slab-kernel forward, plus the model
# tolerance's atol, and agree on as many classes less 0.1 %
Z9_SPREAD_FACTOR = 2.0
# phase 17: the user tools. The held-out trees of tools/evaluate.py (seeds 100,
# 102, 103 at its defaults) with synthetic-r3, whose JAX CPU fp32 values
# BASELINE.md records (medial reduction on, the default filter radius); the
# card's numbers are printed beside them, not gated on them
R3_WEIGHTS = REPO / "smart_tree_tpu" / "weights" / "synthetic-r3.npz"
R2_WEIGHTS = REPO / "smart_tree_tpu" / "weights" / "synthetic-r2.npz"
EVAL_SEEDS = (100, 102, 103)
BASELINE_R3 = {
    100: dict(iou_branch=0.9919, iou_foliage=0.9399, radius_mae=0.0040, direction_cos=0.7625,
              precision_dist=0.0597, n_branches=91),
    102: dict(iou_branch=0.9903, iou_foliage=0.9315, radius_mae=0.0039, direction_cos=0.8466,
              precision_dist=0.0573, n_branches=54),
    103: dict(iou_branch=0.9891, iou_foliage=0.9178, radius_mae=0.0043, direction_cos=0.7272,
              precision_dist=0.0578, n_branches=103),
}
# tests/test_torch_tools_eval.py's tolerance: one step of the tools' round(x, 4)
EVAL_ATOL = 1e-4 + 1e-9
EVAL_TIMING = ("inference_s", "points_per_s", "skeletonize_s")
# tools/bench_scan.py's defaults: six trees at 8,000 points/m^2
FOREST_TREES = 6
FOREST_POINTS_PER_M2 = 8000.0
# phase 18: the training probes at the JAX tools' defaults, 400 steps each
# but the bf16 run, cut to 200 to hold the phase near its 150 s budget (the
# fp32 runs keep the tools' 400; cpu_probe's `none` run leaves its plateau
# only after some 175 steps). Card against CPU on the first steps: step 0,
# before any update, to fp32 summation order; steps 1 and 2 to the
# five-Adam-step tolerance of tests/test_torch_train_step.py
PROBE_LOG_EVERY = 25
PROBE_RUNS = (   # (name, tool, steps, settings)
    ("overfit_lr0.05", "overfit_probe", 400, dict(lr=0.05)),
    ("overfit_lr0.01", "overfit_probe", 400, dict(lr=0.01)),
    ("overfit_lr0.01_bf16", "overfit_probe", 200, dict(lr=0.01, fp16=True)),
    ("cpu_probe_full", "cpu_probe", 400, dict(aug="full")),
    ("cpu_probe_none", "cpu_probe", 400, dict(aug="none")),
)
PROBE_ON_CPU = ("overfit_lr0.01", "cpu_probe_full")
PROBE_CHECK_STEPS = 3
PROBE_FIRST_RTOL = 1e-4
PROBE_RTOL = 2e-2
PROBE_WARMUP_STEPS = 5
PROBE_LOSSES = ("radius", "direction", "class_l")
# phase 19: the port's bench (smart_tree_tpu_torch/bench.py) at its shipped
# defaults, as a subprocess; its tree is the bench tree of PERF.md section 2
BENCH_POINTS = 356709
BENCH_TIMEOUT_S = 600
# phase 20: batch sizing at the card's budget. Synthetic batches of four 4 m
# blocks, 8 m apart, each SIZING_FILL / 4 of the capacity in occupied 1 cm
# voxels of a SIZING_SIDE^3 cube, one point a voxel within SIZING_JITTER
# voxel of its centre (the first point of a block, in voxel 0, SIZING_ANCHOR
# off, so that it is the block's minimum corner and every other point floors
# into its own voxel), in two layouts: "layers", horizontal layers
# SIZING_LAYER_VOXELS apart (dense surfaces: each level some 4x smaller than
# the one above), and "random", voxels drawn at random through the cube
# (some 3 outputs a voxel at the stride-2 convs, so levels grow past the
# batch capacity: the exact plans' worst case)
SIZING_MIN_CAPACITY = 65536
SIZING_FILL = 0.7
SIZING_SIDE = 360
SIZING_LAYER_VOXELS = 10
SIZING_JITTER = 0.2
SIZING_ANCHOR = -0.45
# the ceiling the port copied from the JAX bench (the TPU host's compile
# helper), set on a second ModelInference in (e) only, to compare plans
OLD_CEILING = 262144
FOREST_COMPARE_BLOCKS = 16
# the forest's densest blocks, whose batches run alone in phases 20 (b) and 21
FOREST_DENSE_BLOCKS = 8
# phase 3 (b), the dispatch crossover: the row counts each (Cin, Cout) is
# timed at (ragged ones, and two under the 128-row tile), up to the card's
# largest batch; B2 while its table holds at most 4x the TPU kernel's 8 MiB
# VMEM gate; the plain versions checked CROSSOVER_CHECK_ROWS rows at a time
CROSSOVER_ROWS = (37, 100, 256, 1001, 4096, 16411, 65536, 262147, 1048576, 4194304)
CROSSOVER_TABLE_BYTES = 32 << 20
CROSSOVER_CHECK_ROWS = 262144
# phase 22: the outlier filter's count as the skeletonizer calls it
NB_POINTS = 8
MIN_FILTER_RADIUS = 0.02


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"# {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def exact_knn(torch, np, pts, k: int, r: float, seed: int) -> dict:
    """knn and grid_knn on the card for EXACT_ROWS query rows of `pts` (drawn
    from a seed) against all of `pts`, each distance held against the float64
    recompute of its pair on the host. Returns each function's largest
    relative error, worst error over the bound and the seconds taken;
    raises on a breach."""
    from smart_tree_tpu_torch.neighbors import grid_knn, knn

    t0 = time.perf_counter()
    rows = torch.randperm(pts.shape[0], generator=torch.Generator().manual_seed(seed))
    q = pts[rows[:EXACT_ROWS].to(pts.device)]
    coord_ulps = 2 * float(np.spacing(np.float32(float(pts.abs().max()))))
    out = {"rows": int(q.shape[0]), "k": k, "r": r, "coord_ulps_m": coord_ulps}
    for name, fn, atol in (("knn", knn, coord_ulps), ("grid_knn", grid_knn, 0.0)):
        d, i = fn(q, pts, k, r)
        hit = (i >= 0).cpu().numpy()
        dst = pts[i.clamp_min(0)].double().cpu().numpy()
        diff = q.double().cpu().numpy()[:, None, :] - dst
        exact = np.sqrt((diff * diff).sum(-1))[hit]
        err = np.abs(d.cpu().numpy()[hit] - exact)
        bound = EXACT_RTOL * exact + atol   # 0 for a point and itself in the grid
        over = float(np.where(err == 0, 0.0, err / np.maximum(bound, 1e-300)).max(initial=0.0))
        pos = exact > 0
        out[name] = {"pairs": int(hit.sum()), "worst_over_bound": over,
                     "max_rel_err": float((err[pos] / exact[pos]).max()) if pos.any() else 0.0}
        if not hit.any() or over > 1:
            raise AssertionError(f"{name}: distances off the float64 recompute, {out[name]}")
    out["seconds"] = time.perf_counter() - t0
    return out


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
               dist=dist, preds=preds, root_dist=root_dist, pts=pts, radii=radii)
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


def predicted(np, mi):
    """`mi` with its forward taken by its predict(), the full fp32 download:
    the argmax class and exp(radius) * direction made on the host, rows of a
    class outside `medial_classes` zeroed, as the forward's Cloud. The
    phases that hold the forward against the full download run this."""
    from smart_tree_tpu_torch.data.cloud import Cloud

    def forward(cloud, stats=None):
        p = mi.predict(cloud, stats)
        cls = np.argmax(p["class_logits"], axis=1)
        medial_vector = np.exp(p["radius"]) * p["direction"]
        if mi.medial_classes is not None:
            medial_vector[~np.isin(cls, mi.medial_classes)] = 0.0
        return Cloud(xyz=p["xyz"], rgb=p["rgb"], medial_vector=medial_vector,
                     class_l=cls.reshape(-1, 1).astype(np.float32), filename=cloud.filename)

    mi.forward = forward
    return mi


def transfer_phase(torch, np, cloud, card):
    """Phase 14 on the bench tree at bf16: the native host dedup against the
    numpy one on every block, and the full download (`predicted`) and
    ModelInference.forward without and with the download cull (modes full,
    compact and culled) held against each other, with bytes moved and
    seconds at max_in_flight 1 and 2; then the culled forward with
    fused=True. Returns the `transfers` line."""
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
        return ModelInference(WEIGHTS, batch_size=4, precision="bfloat16", **kw)

    def counted_forward(mi):
        """(cloud, seconds, B1 launches, B2 launches, link bytes) of one forward."""
        mi.link_bytes.update(upload=0, download=0)
        slab_conv.slab_gather_conv.launches = 0
        fused_conv.fused_gather_gemm.launches = 0
        out, dt = synced(lambda: mi.forward(cloud))
        return (out, dt, slab_conv.slab_gather_conv.launches,
                fused_conv.fused_gather_gemm.launches, dict(mi.link_bytes))

    modes = {"full": predicted(np, make()), "compact": make(),
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

    # the culled fp32 forward with fused=True (B2 on every conv it takes,
    # route 3 on the rest) against the plain culled fp32 forward
    fused, plain = (ModelInference(WEIGHTS, batch_size=4, precision="float32",
                                   medial_classes=[0], fused=f) for f in (True, False))
    for mi in (fused, plain):
        mi.forward(cloud)  # warm-up
    out_f, fused_s, slab_f, fused_n, _ = counted_forward(fused)
    out_p = plain.forward(cloud)
    if slab_f != 0 or fused_n == 0:
        raise AssertionError(f"culled fp32 fused forward: {slab_f} slab, {fused_n} fused "
                             "launches")
    np.testing.assert_array_equal(out_f.xyz, out_p.xyz)
    agree_fused = float((out_f.class_l == out_p.class_l).mean())
    if agree_fused < 0.99:
        raise AssertionError(f"culled fused vs culled, fp32: class agreement {agree_fused}")
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
    the full download of `predicted` (equal rows; the slab kernel
    launched); (b) fit_smoke data-parallel on two gloo ranks on the card
    against the same two ranks on the CPU, and in a one-rank NCCL group against phase 12's one-device
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
    for mode, kw in (("culled", dict(medial_classes=[0])), ("full", {})):
        pair = {}
        for name, devices in (("one", ["cuda:0"]), ("two_replicas", ["cuda:0", "cuda:0"])):
            mi = ModelInference(WEIGHTS, batch_size=4, precision="bfloat16", devices=devices,
                                **kw)
            if mode == "full":
                predicted(np, mi)
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

def on_route3(sparse_ops, fn):
    """fn() with the slab kernel's wrapper swapped for route 3 at bf16 (the
    gather and matmul of the same rounded operands), so that every conv of
    a bf16 forward takes route 3; the wrapper is restored after."""
    slab = sparse_ops.slab_conv.slab_gather_conv
    cfg = sparse_ops.ConvConfig("bfloat16")
    sparse_ops.slab_conv.slab_gather_conv = lambda f, rb, w: sparse_ops._gather_gemm(
        f, rb, w, cfg, cfg.chunked(rb.shape[0], w.shape[0] * w.shape[1]))
    try:
        return fn()
    finally:
        sparse_ops.slab_conv.slab_gather_conv = slab


def median_ms(torch, fn, repeats: int = 5, warmup: int = 1) -> float:
    """Median milliseconds of `repeats` calls after `warmup`, each call timed
    by its own pair of CUDA events (host launch gaps included, as a caller
    sees them)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def z9_phase(torch, np, mi16, batches):
    """Phase 16 (a)-(c) on the bench tree's batches: the lookup rulebook
    builders and subm_rulebook9 (card against CPU), the z9 subm convs against
    the full rulebook's (route 3 at fp32, the slab kernel at bf16), SmartTree
    on z9 plans against full plans, the slab kernel's launches and the times.
    Returns the `z9` part of the phase's line."""
    from smart_tree_tpu_torch.core import rulebook as rbm
    from smart_tree_tpu_torch.core import slab_conv, sparse_ops
    from smart_tree_tpu_torch.core.sparse_ops import ConvConfig, gather_conv

    model = mi16.model
    planes = model.unet_planes
    # the exact plans the bf16 forward runs; the z9 plans are exact too
    settled = [(x, plan) for x, plan, _ in (mi16._plan_batch(vb) for vb in batches)]

    # (a) rulebooks
    checked = 0
    for x, plan in settled:
        for lvl, lv in enumerate(plan.levels):
            rb9 = rbm.subm_rulebook9(lv.keys, lv.spatial_shape, plan.batch_size)
            rb9_cpu = rbm.subm_rulebook9(lv.keys.cpu(), lv.spatial_shape, plan.batch_size)
            if not (torch.equal(rb9.pos.cpu(), rb9_cpu.pos)
                    and torch.equal(rb9.qkey.cpu(), rb9_cpu.qkey)):
                raise AssertionError(f"subm_rulebook9 level {lvl}: the card differs from the CPU")
            if not torch.equal(sparse_ops._window_rulebook(rb9, rb9.pos, rb9.qkey), lv.subm_rb):
                raise AssertionError(f"level {lvl}: the z9 window rows are not the subm rulebook")
            checked += 1
            if lvl + 1 < len(plan.levels):
                nxt = plan.levels[lvl + 1]
                args = (lv.keys, nxt.keys, lv.spatial_shape, nxt.spatial_shape, plan.batch_size)
                if not torch.equal(rbm.strided_rulebook(*args), lv.down_rb):
                    raise AssertionError(f"level {lvl}: strided_rulebook != the plan's")
                if not torch.equal(rbm.inverse_rulebook(*args), lv.up_rb):
                    raise AssertionError(f"level {lvl}: inverse_rulebook != the plan's")
                checked += 2

    def plans(mode):
        return [(x, model.build_plan(x, level_capacity_factor=None, subm_mode=mode))
                for x, _ in settled]

    z9_plans, full_plans = plans("z9"), plans("full")
    full_rb = {id(zl.subm_rb): fl.subm_rb
               for (_, zp), (_, fp) in zip(z9_plans, full_plans)
               for zl, fl in zip(zp.levels, fp.levels)}

    def forward(pairs, precision):
        with torch.no_grad():
            return [model(p, x.feats, ConvConfig(precision)) for x, p in pairs]

    # (b) and the bf16 per-conv check: every subm conv of a z9 forward held
    # on its own inputs against the full rulebook's conv (these comparison
    # launches of the slab kernel are made outside the counted run below)
    per_conv = {"float32": [], "bfloat16": []}
    zconv = sparse_ops._gather_conv_z

    def held(feats, rb, w, cfg):
        out = zconv(feats, rb, w, cfg)
        full = full_rb[id(rb)]
        if cfg.precision == "float32":
            ref = gather_conv(feats, full, w, cfg)       # route 3
            ok = torch.allclose(out, ref, rtol=1e-6, atol=1e-6)
        else:
            ref = slab_conv.slab_gather_conv(feats, full, w)
            k = full.shape[1] * w.shape[1]
            scale = sparse_ops._gather_gemm(feats.abs(), full, w.abs(), cfg, False)
            ok = bool(((out - ref).abs() <= SLAB_ATOL + 2 * (k - 1) * FP32_UNIT * scale).all())
        err = float((out - ref).abs().max())
        if not ok:
            raise AssertionError(f"{cfg.precision} z9 subm conv {tuple(w.shape)} M={full.shape[0]}: "
                                 f"max abs err {err} against the full rulebook")
        per_conv[cfg.precision].append(err)
        return out

    sparse_ops._gather_conv_z = held
    try:
        outs = {(mode, prec): forward(pairs, prec)
                for prec in ("float32", "bfloat16")
                for mode, pairs in (("z9", z9_plans), ("full", full_plans))}
    finally:
        sparse_ops._gather_conv_z = zconv
    # the yardstick: the full plans at bf16 with every conv on route 3
    with torch.no_grad():
        spread_ref = on_route3(sparse_ops, lambda: [model(p, x.feats, ConvConfig("bfloat16"))
                                                    for x, p in full_plans])
    subm_per_forward = len(per_conv["float32"])
    if subm_per_forward != sum(1 for _, p in z9_plans for c in unet_convs(p, planes)
                               if ".Head." in c[0] or ".Tail." in c[0]):
        raise AssertionError(f"{subm_per_forward} z9 subm convs in one forward")

    # (c) the whole forward, z9 against full: per head the largest difference
    # over the batches' active rows, and the share of rows whose class agrees
    def compare(outs_a, outs_b):
        err, agree, total = {}, 0, 0
        for a, b, (x, _) in zip(outs_a, outs_b, full_plans):
            act = x.active
            for k in ("radius", "direction", "class_l"):
                d = float((a[k][act].float() - b[k][act].float()).abs().max())
                err[k] = max(err.get(k, 0.0), d)
            agree += int((a["class_l"][act].argmax(1) == b["class_l"][act].argmax(1)).sum())
            total += int(act.sum())
        return err, agree / total

    head_err = {}
    for prec in ("float32", "bfloat16"):
        err, agree = compare(outs[("z9", prec)], outs[("full", prec)])
        head_err[prec] = dict(err, class_agreement=agree)
    fp32 = head_err["float32"]
    for a, b, (x, _) in zip(outs[("z9", "float32")], outs[("full", "float32")], full_plans):
        for k in ("radius", "direction", "class_l"):
            if not torch.allclose(a[k][x.active], b[k][x.active], **MODEL_TOL):
                raise AssertionError(f"fp32 z9 forward {k}: max abs err {fp32[k]}")
    spread, spread_agree = compare(spread_ref, outs[("full", "bfloat16")])
    head_err["bfloat16_spread"] = dict(spread, class_agreement=spread_agree)
    bf16 = head_err["bfloat16"]
    for k in ("radius", "direction", "class_l"):
        if bf16[k] > Z9_SPREAD_FACTOR * spread[k] + MODEL_TOL["atol"]:
            raise AssertionError(f"bf16 z9 forward {k}: max abs err {bf16[k]}, the full plan's "
                                 f"own spread {spread[k]}")
    if bf16["class_agreement"] < spread_agree - 1e-3:
        raise AssertionError(f"bf16 z9 forward: class agreement {bf16['class_agreement']}, "
                             f"the full plan's own {spread_agree}")

    # the slab kernel's launches in one bf16 forward on each plan, against the
    # count the plans imply: every 27-column conv, on the z9 plans only the
    # strided (Encode) and inverse (Decode) ones
    def expected(pairs, subm_too):
        return sum(int(subm_too or name.endswith(("Encode", "Decode")))
                   for _, p in pairs for name, *_ in unet_convs(p, planes))

    launches = {}
    for mode, pairs in (("z9", z9_plans), ("full", full_plans)):
        slab_conv.slab_gather_conv.launches = 0
        forward(pairs, "bfloat16")
        torch.cuda.synchronize()
        launches[mode] = slab_conv.slab_gather_conv.launches
    want = {"z9": expected(full_plans, False), "full": expected(full_plans, True)}
    if launches != want or launches["z9"] == 0:
        raise AssertionError(f"slab launches per bf16 forward {launches}, the plans imply {want}")

    # times: the plans' build and the UNet, per mode and precision
    times = {}
    for mode in ("z9", "full"):
        times[f"{mode}_plan_ms"] = median_ms(
            torch, lambda: [model.build_plan(x, level_capacity_factor=None, subm_mode=mode)
                            for x, _ in settled])
        for prec in ("float32", "bfloat16"):
            pairs = z9_plans if mode == "z9" else full_plans
            times[f"{mode}_{prec}_forward_ms"] = median_ms(torch, lambda: forward(pairs, prec))
    result = {
        "batches": len(settled), "rulebooks_checked": checked,
        "subm_convs_per_forward": subm_per_forward,
        "subm_conv_max_abs_err": {k: max(v) for k, v in per_conv.items()},
        "head_max_abs_err": head_err,
        "slab_launches_per_bf16_forward": launches, "times": times,
    }
    log(f"z9: {result}")
    return result


def remaining_phase(torch, np, mi16, batches, labelled, skeleton, ply_expected, stages,
                    scripts, card):
    """Phase 16: z9_phase, then (d) connect_skeletons, sssp and sample_tree,
    the card against the CPU, and (e) the viewer on the bench tree, plus the
    data scripts' numbers `scripts` (run on phase 11's corpus). Returns the
    `remaining_modules` line."""
    import copy
    import logging

    from smart_tree_tpu_torch.graph import sssp, tree_distances
    from smart_tree_tpu_torch.skeleton import connect_skeletons, sample_tree
    from smart_tree_tpu_torch.skeleton import path as tpath
    from smart_tree_tpu_torch.viz import viewer

    t0 = time.perf_counter()
    result = {"card": card, "z9": z9_phase(torch, np, mi16, batches)}

    # (d) connect the bench tree's skeletons on the card and on the CPU, at the
    # default distance and at one past every secondary root, which grafts all
    if len(skeleton.skeletons) < 2:
        raise AssertionError("phase 8 gave one skeleton: nothing to connect")
    connected = {}
    for max_distance in (0.5, float("inf")):
        joined = {dev: connect_skeletons(copy.deepcopy(skeleton), max_distance, device=dev)
                  for dev in ("cuda", "cpu")}
        same_skeletons(np, joined["cuda"], joined["cpu"], "connect_skeletons card vs cpu",
                       GEOM_TOL)
        for a, b in zip(joined["cuda"].skeletons, joined["cpu"].skeletons):
            if list(a.branches) != list(b.branches):
                raise AssertionError("connect_skeletons: the card and the CPU number branches "
                                     "apart")
        connected[str(max_distance)] = len(joined["cpu"].skeletons)
    if connected["inf"] != 1:
        raise AssertionError(f"connect_skeletons at any distance left {connected['inf']} "
                             "skeletons")
    # sssp from the small tree's first root, then sample_tree on its component
    s = stages
    n = len(s["pts"])
    root = int(s["roots"][0])
    if root < 0:
        raise AssertionError("the small tree's first component has no root")
    paths = {}
    for dev in ("cuda", "cpu"):
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        dist, pred = sssp(up(s["edges"]), up(s["weights"]), up(s["edge_valid"]), root, n)
        hop = up(s["pts"]) - up(s["pts"])[pred.clamp_min(0)]
        rd = tree_distances(pred, (hop * hop).sum(1).sqrt(), n)
        paths[dev] = (dist.cpu().numpy(), pred.cpu().numpy(), rd.cpu().numpy())
    np.testing.assert_array_equal(paths["cuda"][1], paths["cpu"][1], err_msg="sssp preds")
    fin = np.isfinite(paths["cpu"][0])
    np.testing.assert_array_equal(np.isfinite(paths["cuda"][0]), fin, err_msg="sssp reach")
    np.testing.assert_allclose(paths["cuda"][0][fin], paths["cpu"][0][fin], **DIST_TOL,
                               err_msg="sssp dist")
    _, pred, rd = paths["cpu"]
    mask = s["labels"] == s["labels"][root]
    tpath.greedy_steps.launches = 0
    trees = {dev: sample_tree(s["pts"], s["radii"], pred, rd, mask, device=dev)
             for dev in ("cuda", "cpu")}
    if tpath.greedy_steps.launches == 0:
        raise AssertionError("sample_tree on the card launched no tracer kernel")
    if len(trees["cpu"]) < 2 or list(trees["cuda"]) != list(trees["cpu"]):
        raise AssertionError(f"sample_tree: branches {list(trees['cuda'])} on the card, "
                             f"{list(trees['cpu'])} on the CPU")
    for k, a in trees["cuda"].items():
        b = trees["cpu"][k]
        if a.parent_id != b.parent_id:
            raise AssertionError(f"sample_tree branch {k}: parent {a.parent_id} != {b.parent_id}")
        np.testing.assert_allclose(a.xyz, b.xyz, **GEOM_TOL, err_msg=f"sample_tree {k} xyz")
        np.testing.assert_allclose(a.radii, b.radii, **GEOM_TOL, err_msg=f"sample_tree {k} radii")
    result["skeleton"] = {
        "skeletons_before": len(skeleton.skeletons),
        "skeletons_after_connect_by_max_distance": connected,
        "sssp_reached": int(fin.sum()), "sssp_vertices": n,
        "sample_tree_branches": len(trees["cpu"]),
        "tracer_launches": tpath.greedy_steps.launches,
    }

    # (e) the viewer's geometry against phase 8's PLYs, and the view itself
    items = {i.name: i.data for i in viewer.viewer_items(labelled, skeleton,
                                                        cmap=((1, 0, 0), (0, 1, 0)))}
    found = {
        "cloud.ply": {"vertex": len(items["cloud"]["xyz"])},
        "seg_cld.ply": {"vertex": len(items["seg_cloud"]["xyz"])},
        "skeleton.ply": {"vertex": len(items["skeleton"]["vertices"]),
                         "edge": len(items["skeleton"]["edges"])},
        "mesh.ply": {"vertex": len(items["tube_mesh"]["vertices"]),
                     "face": len(items["tube_mesh"]["triangles"])},
    }
    if found != ply_expected:
        raise AssertionError(f"viewer_items: {found}, phase 8's PLYs hold {ply_expected}")
    warned = []
    handler = logging.Handler()
    handler.emit = lambda record: warned.append(record.getMessage())
    logging.getLogger(viewer.__name__).addHandler(handler)
    try:
        if viewer.HAVE_O3D:
            log("open3d is installed here: view_skeleton would open a window, not called")
        elif viewer.view_skeleton(skeleton, labelled) is not None or len(warned) != 1:
            raise AssertionError(f"view_skeleton without open3d: warnings {warned}")
    finally:
        logging.getLogger(viewer.__name__).removeHandler(handler)
    result["viewer"] = {"items": sorted(items), "ply_counts": found, "warnings": warned}
    result["scripts"] = scripts
    result["phase_s"] = time.perf_counter() - t0 + scripts["seconds"]
    log(f"remaining modules: {result}")
    return result


def corpus_scripts(work: Path) -> dict:
    """split_data and one bench_dataloader epoch on a corpus directory of
    tree npz files: the split's sizes and the epoch's numbers."""
    from smart_tree_tpu_torch.scripts import bench_dataloader, split_data

    t0 = time.perf_counter()
    out = work / "split_data.json"
    if split_data.main([str(work), "-o", str(out)]) != 0:
        raise AssertionError("split_data returned non-zero")
    split = json.loads(out.read_text())
    epochs: list = []
    if bench_dataloader.main([str(work), "--json-path", str(out), "--epochs", "1"],
                             stats=epochs) != 0:
        raise AssertionError("bench_dataloader returned non-zero")
    if len(epochs) != 1 or epochs[0]["items"] != len(split["train"]):
        raise AssertionError(f"bench_dataloader epoch {epochs}, split {split}")
    result = {"split_sizes": {k: len(v) for k, v in split.items()},
              "bench_dataloader_epoch": epochs[0], "seconds": time.perf_counter() - t0}
    log(f"corpus scripts: {result}")
    return result


def reference_pt(torch, npz: Path, path: Path) -> Path:
    """The checkpoint `npz` as the reference's spconv state_dict at `path`:
    module paths joined with dots, BatchNorm weight / bias / running_mean /
    running_var and num_batches_tracked, conv kernels (Cout, kx, ky, kz, Cin)."""
    from smart_tree_tpu_torch.nn.convert import (flax_path, load_npz, model_from_variables,
                                                 torch_key_for)

    sd = load_npz(npz)
    buffers = {name for name, _ in model_from_variables(sd).named_buffers()}
    out = {}
    for key, v in sd.items():
        collection = "batch_stats" if key in buffers else "params"
        if v.ndim == 3:                 # [K3, Cin, Cout] -> (Cout, k, k, k, Cin)
            k = round(v.shape[0] ** (1 / 3))
            v = v.reshape(k, k, k, v.shape[1], v.shape[2]).permute(4, 0, 1, 2, 3)
        out[torch_key_for(flax_path(key), collection)] = v.contiguous()
        if key.endswith(".mean"):
            out[key[: -len("mean")] + "num_batches_tracked"] = torch.tensor(7)
    torch.save(out, path)
    return path


def captured_json(fn) -> list:
    """Run fn() with its standard output captured; the JSON values it printed,
    one a line, or one indented value."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if fn() != 0:
            raise AssertionError(f"{fn} returned non-zero")
    text = buf.getvalue().strip()
    try:
        return [json.loads(text)]
    except json.JSONDecodeError:
        return [json.loads(line) for line in text.splitlines()]


def tools_phase(torch, np, card):
    """Phase 17: the port's user tools (smart_tree_tpu_torch/tools/) on the
    card, through their entry points. Returns (the `tools` line, the slab
    kernel's launches in the bf16 evaluations, in the forest scan, and the
    forest's branch points and radii as the skeleton stage got them)."""
    import contextlib

    from smart_tree_tpu_torch.core import slab_conv
    from smart_tree_tpu_torch.data.dataset import BlockTiler, TreeDataset
    from smart_tree_tpu_torch.neighbors import grid_count
    from smart_tree_tpu_torch.infer.inference import ModelInference
    from smart_tree_tpu_torch.tools import (bench_scan, convert_checkpoint, diagnose_direction,
                                            diagnose_e2e, evaluate, make_synthetic_dataset)

    t_phase = time.perf_counter()
    result = {"card": card}
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        # (a) a dataset at the tool's default densities, loaded by the trainer's dataset
        t0 = time.perf_counter()
        data = work / "trees"
        with contextlib.redirect_stdout(sys.stderr):   # its log lines, off the result lines
            code = make_synthetic_dataset.main([str(data), "--per-family", "1"])
        if code != 0:
            raise AssertionError("make_synthetic_dataset returned non-zero")
        split = json.loads((data / "split.json").read_text())
        files = sorted(p.name for p in data.glob("*.npz"))
        if len(files) != 6 or sorted(sum(split.values(), [])) != files:
            raise AssertionError(f"make_synthetic_dataset wrote {files}, split {split}")
        voxels = {}
        for mode, names in split.items():
            if not names:
                continue
            ds = TreeDataset(0.01, data / "split.json", data, mode, ["xyz"],
                             ["radius", "direction", "class_l"])
            for i in range(len(ds)):
                coords, inputs, targets, name, _ = ds.item(i)
                if not (len(coords) > 0 and np.isfinite(inputs).all()
                        and np.isfinite(targets).all()):
                    raise AssertionError(f"dataset item {name} is empty or not finite")
                voxels[name] = len(coords)
        result["dataset"] = {"split_sizes": {k: len(v) for k, v in split.items()},
                             "voxels": voxels, "seconds": time.perf_counter() - t0}
        log(f"make_synthetic_dataset: {result['dataset']}")

        # (b) the checkpoint converter: the shipped npz as a reference .pt, and back
        t0 = time.perf_counter()
        pt = reference_pt(torch, WEIGHTS, work / "noble-elevator-58.pt")
        back = work / "converted.npz"
        with contextlib.redirect_stdout(sys.stderr):
            code = convert_checkpoint.main([str(pt), str(back)])
        if code != 0:
            raise AssertionError("convert_checkpoint returned non-zero")
        with np.load(back) as a, np.load(WEIGHTS) as b:
            if sorted(a.files) != sorted(b.files):
                raise AssertionError("convert_checkpoint: other entries than the shipped npz")
            for k in a.files:
                if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"convert_checkpoint: {k} differs from the shipped npz")
            result["convert"] = {"arrays": len(a.files), "seconds": time.perf_counter() - t0}
        log(f"convert_checkpoint: {result['convert']}")

    # (c) quality: evaluate_tree on the held-out seeds at fp32 and bf16
    def quality(weights, seeds):
        out, launches = {}, {}
        for precision in ("float32", "bfloat16"):
            mi = ModelInference(weights, precision=precision)
            for seed in seeds:
                slab_conv.slab_gather_conv.launches = 0
                m = evaluate.evaluate_tree(mi, seed)
                if precision == "bfloat16":
                    launches[seed] = slab_conv.slab_gather_conv.launches
                bad = [k for k, v in m.items() if not np.isfinite(v)]
                if bad or "n_branches" not in m:
                    raise AssertionError(f"evaluate_tree {weights.name} seed {seed} "
                                         f"{precision}: no skeleton or non-finite {bad}: {m}")
                out.setdefault(seed, {})[precision] = m
        return out, launches

    t0 = time.perf_counter()
    r3, r3_launches = quality(R3_WEIGHTS, EVAL_SEEDS)
    if sum(r3_launches.values()) == 0:
        raise AssertionError(f"the bf16 evaluations never launched the slab kernel: {r3_launches}")
    for seed in EVAL_SEEDS:
        r3[seed]["jax_cpu_fp32_baseline"] = BASELINE_R3[seed]
    cpu = evaluate.evaluate_tree(ModelInference(R3_WEIGHTS, device="cpu"), EVAL_SEEDS[0])
    card32 = r3[EVAL_SEEDS[0]]["float32"]
    off = {k: (card32.get(k), v) for k, v in cpu.items() if k not in EVAL_TIMING and not (
        k in card32 and abs(card32[k] - v) <= (0 if isinstance(v, int) else EVAL_ATOL))}
    r3[EVAL_SEEDS[0]]["cpu_float32"] = cpu
    noble, noble_launches = quality(WEIGHTS, EVAL_SEEDS[:1])
    log("evaluate (synthetic-r3; card fp32 / card bf16 / JAX CPU fp32, BASELINE.md):")
    for seed in EVAL_SEEDS:
        for key in BASELINE_R3[seed]:
            log(f"  seed {seed} {key}: {r3[seed]['float32'].get(key)} / "
                f"{r3[seed]['bfloat16'].get(key)} / {BASELINE_R3[seed][key]}")
    result["evaluate"] = {
        "synthetic-r3": r3, "noble-elevator-58": noble,
        "bf16_slab_launches": {"synthetic-r3": r3_launches, "noble-elevator-58": noble_launches},
        "seconds": time.perf_counter() - t0,
    }
    # a disagreement fails the phase at its end, after the other tools have run
    problems = [f"evaluate_tree seed {EVAL_SEEDS[0]} fp32, card against the CPU past "
                f"{EVAL_ATOL}: {off}"] if off else []

    # the two diagnostics through their entry points, on the card
    t0 = time.perf_counter()
    result["diagnose_direction"] = captured_json(
        lambda: diagnose_direction.main([str(R3_WEIGHTS), "--seed", str(EVAL_SEEDS[0])]))[0]
    e2e = captured_json(lambda: diagnose_e2e.main([str(R2_WEIGHTS)]))
    if [line["stage"] for line in e2e] != ["model", "predicted", "oracle"]:
        raise AssertionError(f"diagnose_e2e printed {e2e}")
    result["diagnose_e2e"] = e2e
    result["diagnose_s"] = time.perf_counter() - t0
    log(f"diagnostics: {result['diagnose_direction']} {e2e}")

    # (d) the forest scan at bench_scan's defaults, with the skeleton stage
    t0 = time.perf_counter()
    cloud = bench_scan.make_forest(FOREST_TREES, FOREST_POINTS_PER_M2)
    make_s = time.perf_counter() - t0
    log(f"forest: {len(cloud)} points in {make_s:.1f} s")
    # the host tiling alone (one of the forward's layers), as the forward tiles
    t0 = time.perf_counter()
    tiler = BlockTiler(cloud, 0.01, 4.0, 0.4)
    cap = ModelInference(WEIGHTS, precision="bfloat16").max_batch_capacity
    n_batches = sum(1 for _ in tiler.batches(4, max_capacity=cap))
    tiling = {"blocks": len(tiler), "batches": n_batches, "max_batch_capacity": cap,
              "seconds": time.perf_counter() - t0}
    del tiler
    slab_conv.slab_gather_conv.launches = 0
    grid_count.grid_radius_count.launches = 0
    report, lc, skel = bench_scan.scan(cloud, FOREST_TREES, skeletonize=True)
    forest_launches = slab_conv.slab_gather_conv.launches
    forest_count_launches = grid_count.grid_radius_count.launches
    if forest_launches == 0:
        raise AssertionError("the forest scan never launched the slab kernel")
    if forest_count_launches == 0:
        raise AssertionError("the forest scan's outlier filter never launched the count kernel")
    if report["unet_passes"] != n_batches:
        raise AssertionError(f"forest scan: {report['unet_passes']} UNet passes a forward for "
                             f"{n_batches} batches")
    for k in ("xyz", "medial_vector", "class_l"):
        if not np.isfinite(getattr(lc, k)).all():
            raise AssertionError(f"forest scan: non-finite {k}")
    branches = sum(len(s.branches) for s in skel.skeletons)
    if len(skel.skeletons) < 1 or branches < FOREST_TREES:
        raise AssertionError(f"forest scan: {len(skel.skeletons)} skeletons, {branches} branches")
    pts = np.concatenate([b.xyz for s in skel.skeletons for b in s.branches.values()])
    lo, hi = cloud.xyz.min(0) - 1.0, cloud.xyz.max(0) + 1.0
    if not ((pts >= lo) & (pts <= hi)).all():
        raise AssertionError("forest scan: a skeleton point outside the scan bounds +-1 m")
    # the forest's graph vertices as the skeleton stage reduces them (one
    # medial point per 1 cm cell), trees up to some 30 m from the origin
    from smart_tree_tpu_torch.skeleton.quantize import medial_reduce

    branch = lc.filter_by_class([0])
    fp, fy = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
              for a in (branch.medial_pts, branch.xyz[:, 1]))
    rep, _ = medial_reduce(fp, fy, torch.ones(fp.shape[0], dtype=torch.bool, device=fp.device),
                           0.01)
    report["exact"] = exact_knn(torch, np, fp[rep], 16, FOREST_EXACT_R, seed=17)
    log(f"forest knn / grid_knn against float64: largest relative error "
        f"{report['exact']['knn']['max_rel_err']:.3g} / "
        f"{report['exact']['grid_knn']['max_rel_err']:.3g}, {report['exact']['seconds']:.2f} s "
        f"({card})")
    del fp, fy, rep
    report.update(make_forest_s=make_s, host_tiling=tiling, extent_m=(cloud.xyz.max(0) - cloud.xyz.min(0)).tolist(),
                  output_voxels=len(lc), slab_launches=forest_launches,
                  count_launches=forest_count_launches,
                  skeletons_per_component=[len(s.branches) for s in skel.skeletons])
    result["forest_scan"] = report
    result["phase_s"] = time.perf_counter() - t_phase
    result["script_s"] = time.perf_counter() - T_START
    log(f"forest scan: {report}")
    if problems:
        raise AssertionError("; ".join(problems))
    return (result, sum(r3_launches.values()), forest_launches,
            (branch.medial_pts, branch.radius))


def probes_phase(torch, np, card):
    """Phase 18: the training probes (smart_tree_tpu_torch/tools/
    {overfit_probe,cpu_probe}.py) on the card, PROBE_RUNS, the first steps of two of them again on the CPU. Returns (the `probes`
    line, each hand kernel's launches in the card's probe steps, the checks
    that failed), so that the caller prints the line before it fails."""
    from smart_tree_tpu_torch.core import fused_conv, slab_conv
    from smart_tree_tpu_torch.tools import cpu_probe, overfit_probe

    tools = {"overfit_probe": overfit_probe, "cpu_probe": cpu_probe}
    t_phase = time.perf_counter()
    result = {"card": card}
    problems, card_runs = [], {}
    slab_conv.slab_gather_conv.launches = 0
    fused_conv.fused_gather_gemm.launches = 0
    for name, tool, steps, settings in PROBE_RUNS:
        lines = []

        def echo(s, name=name, lines=lines):
            lines.append(s)
            log(f"{name}: {s}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        recs = tools[tool].run(steps=steps, log_every=PROBE_LOG_EVERY, echo=echo, **settings)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        # each step's seconds end with its losses fetched, which waits for the card
        step_s = np.diff([0.0] + [r["seconds"] for r in recs])
        bad = [r["step"] for r in recs if not all(np.isfinite(r[k]) for k in PROBE_LOSSES)]
        if bad:
            problems.append(f"{name}: non-finite losses at steps {bad[:10]}")
        card_runs[name] = recs
        result[name] = {
            "tool": tool, "steps": steps, "settings": settings,
            "curve": [r for r in recs if overfit_probe.logged(r["step"], steps,
                                                              PROBE_LOG_EVERY)],
            "median_step_s": float(np.median(step_s[PROBE_WARMUP_STEPS:])),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "seconds": seconds,
        }
        if tool == "overfit_probe":
            result[name]["tree"] = lines[0]
    launches = {"slab_gather_conv": slab_conv.slab_gather_conv.launches,
                "fused_gather_gemm": fused_conv.fused_gather_gemm.launches}
    if any(launches.values()):
        problems.append(f"a forward-only hand kernel launched in the probe steps: {launches}")

    # the first steps again on the CPU, from the same seeded weights
    for name, tool, _, settings in PROBE_RUNS:
        if name not in PROBE_ON_CPU:
            continue
        t0 = time.perf_counter()
        cpu = tools[tool].run(steps=PROBE_CHECK_STEPS, device="cpu", **settings)
        rel = []
        for got, ref in zip(card_runs[name], cpu):
            rtol = PROBE_FIRST_RTOL if ref["step"] == 0 else PROBE_RTOL
            rel.append(max(abs(got[k] - ref[k]) / abs(ref[k]) for k in PROBE_LOSSES))
            off = {k: (got[k], ref[k]) for k in PROBE_LOSSES
                   if not abs(got[k] - ref[k]) <= rtol * abs(ref[k])}
            if off:
                problems.append(f"{name} step {ref['step']}, card against CPU past rtol "
                                f"{rtol}: {off}")
        result[name]["cpu_first_steps"] = cpu
        result[name]["cpu_max_rel_diff_by_step"] = rel
        result[name]["cpu_s"] = time.perf_counter() - t0

    # what STATUS.md records for lr 0.01: the direction loss comes down
    run = card_runs["overfit_lr0.01"]
    if not run[-1]["direction"] < run[0]["direction"]:
        problems.append(f"overfit lr 0.01: direction loss {run[0]['direction']} at step 0, "
                        f"{run[-1]['direction']} at step {run[-1]['step']}")
    result["launches"] = launches
    result["phase_s"] = time.perf_counter() - t_phase
    result["script_s"] = time.perf_counter() - T_START
    log(f"probes: {launches}, phase {result['phase_s']:.1f} s, problems {problems}")
    return result, launches, problems


def run_bench_cli(*args: str) -> tuple:
    """`python -m smart_tree_tpu_torch.bench *args` from the repo root, in a
    session of its own that is killed whole on a timeout: (rc, the
    non-empty lines of its standard output)."""
    proc = subprocess.Popen([sys.executable, "-m", "smart_tree_tpu_torch.bench", *args],
                            cwd=REPO, stdout=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise AssertionError(f"bench {args}: no result in {BENCH_TIMEOUT_S} s")
    lines = [ln for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise AssertionError(f"bench {args}: rc {proc.returncode}, no output")
    return proc.returncode, lines


def bench_phase(card):
    """Phase 19: (a) the port's bench at its shipped defaults on the card,
    its line held to the harness's contract; (b) the supervisor with an
    injected fault must exit non-zero with one JSON line carrying `error`;
    (c) the roofline's whole-forward FLOPs and bytes at (a)'s batches'
    exact level rows against its device time, printed, not gated. Returns
    the phase's line."""
    t0 = time.perf_counter()
    rc, lines = run_bench_cli()
    bench = json.loads(lines[-1])
    log(f"bench: rc {rc}, {bench}")
    problems = [f"{k}: {bench[k]}" for k in ("error", "skeleton_error") if k in bench]
    if rc != 0:
        problems.append(f"rc {rc}")
    for key in ("value", "device_step_s", "clouds_per_min_e2e", "slab_launches_per_forward"):
        if not (bench.get(key) or 0) > 0:
            problems.append(f"{key} = {bench.get(key)}")
    if bench.get("n_points") != BENCH_POINTS:
        problems.append(f"n_points {bench.get('n_points')}, the bench tree has {BENCH_POINTS}")
    if problems:
        raise AssertionError(f"the port's bench: {'; '.join(problems)}")
    bench_s = time.perf_counter() - t0

    fault_rc, fault_lines = run_bench_cli("--tiny", "--fault", "raise")
    fault_line = json.loads(fault_lines[-1])
    if fault_rc == 0 or "error" not in fault_line:
        raise AssertionError(f"bench --fault raise: rc {fault_rc}, {fault_line}")
    if sum(ln.lstrip().startswith("{") for ln in fault_lines) != 1:
        raise AssertionError(f"bench --fault raise printed other JSON lines: {fault_lines}")

    if len(bench.get("batch_level_rows") or ()) != len(bench["batch_capacities"]):
        raise AssertionError(f"the bench's level rows {bench.get('batch_level_rows')} are not "
                             f"one exact plan a batch of {bench['batch_capacities']}")
    total = roofline.forward_totals([tuple(r) for r in bench["batch_level_rows"]],
                                    itemsize=roofline.ITEMSIZE["bfloat16"])
    shares = roofline.achieved(total, bench["device_step_s"], "bfloat16")
    log(f"roofline of one forward at {bench['batch_level_rows']}: {total}, {shares}")
    return {"card": card, "bench": bench, "bench_s": bench_s,
            "fault_rc": fault_rc, "fault_error": fault_line["error"],
            "roofline": {**total, **shares, "precision": "bfloat16",
                         "peak_flops": roofline.PEAK_FLOPS["bfloat16"],
                         "peak_bytes_per_s": roofline.HBM_BYTES_PER_S},
            "phase_s": time.perf_counter() - t0}


def dense_blocks(np, n_blocks: int, voxels: int, seed: int, layout: str = "layers"):
    """A cloud of `n_blocks` blocks of `voxels` occupied voxels each in
    `layout` "layers" or "random" (phase 20's synthetic batches; see
    SIZING_* above)."""
    from smart_tree_tpu_torch.data.cloud import Cloud

    rng = np.random.default_rng(seed)
    if layout == "layers":
        layer, rest = np.divmod(np.arange(voxels), SIZING_SIDE * SIZING_SIDE)
        row, col = np.divmod(rest, SIZING_SIDE)
        ijk = [np.stack([row, layer * SIZING_LAYER_VOXELS, col], axis=1)] * n_blocks
    else:
        ijk = []
        for _ in range(n_blocks):
            cells = np.unique(rng.integers(1, SIZING_SIDE ** 3, int(1.05 * voxels) + 64))
            cells = np.concatenate([[0], rng.permutation(cells)[: voxels - 1]])
            if len(cells) != voxels:
                raise AssertionError(f"{len(cells)} random voxels, not {voxels}")
            ijk.append(np.stack(np.unravel_index(cells, (SIZING_SIDE,) * 3), axis=1))
    xyz = []
    for b, cells in enumerate(ijk):
        cells = cells + 0.5
        jitter = rng.uniform(-SIZING_JITTER, SIZING_JITTER, cells.shape)
        jitter[0] = SIZING_ANCHOR
        xyz.append(((cells + jitter) * 0.01 + np.array([8.0 * b + 0.2, 0.2, 0.2]))
                   .astype(np.float32))
    xyz = np.concatenate(xyz)
    return Cloud(xyz=xyz, rgb=np.zeros_like(xyz))


def sizing_phase(torch, np, card):
    """Phase 20: the batch sizing at the card's budget. (a) the budget and
    the largest batch capacity ModelInference plans; (b) at every pow2
    capacity from SIZING_MIN_CAPACITY to it, culled forwards of a batch of
    four blocks in each layout at fp32 and bf16, then the bench tree's and
    the forest's densest blocks' batches alone, one exact plan each, and a
    batch whose exact plan passes a budget sized for its capacity, which
    splits before it runs: each peak allocated held against the footprint
    model (core/memory.py) at the exact level rows of the largest plan run,
    and route 3's gathers at the largest capacity against
    `ConvConfig.chunked`; (c) a cloud of two layered batches at the largest
    capacity, max_in_flight 2, within the budget; (d) the slab kernel on
    level 0 of the largest batch against its plain version, timed; (e) the
    card's plan against the old 262,144 ceiling: equal batches on the bench
    tree and the forest's first blocks, and at fp32 equal predictions on
    four dense blocks that the old ceiling splits. Returns the phase's line
    and (d)'s rows."""
    from smart_tree_tpu_torch.core import slab_conv, sparse_ops, tiler
    from smart_tree_tpu_torch.core.memory import estimate_forward_hbm, footprint_terms
    from smart_tree_tpu_torch.data.augmentations import CentreCloud
    from smart_tree_tpu_torch.data.dataset import BlockTiler
    from smart_tree_tpu_torch.data.synthetic import generate_tree
    from smart_tree_tpu_torch.infer.inference import ModelInference
    from smart_tree_tpu_torch.tools import bench_scan

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    # (a) the budget and the plan
    total_memory = torch.cuda.get_device_properties(dev).total_memory
    mis = {p: ModelInference(WEIGHTS, precision=p, medial_classes=(0,))
           for p in ("float32", "bfloat16")}
    budget = mis["float32"].hbm_budget_bytes
    planes = mis["float32"].model.unet_planes
    plan = {f"{p}_in_flight{k}": ModelInference(WEIGHTS, precision=p, max_in_flight=k)
            .max_batch_capacity for p in ("float32", "bfloat16") for k in (1, 2)}
    max_cap = mis["float32"].max_batch_capacity
    terms = footprint_terms([dev])   # the model's terms as ModelInference sizes with them
    result = {"card": card, "total_memory": total_memory, "budget_bytes": budget,
              "max_batch_capacity": plan, "footprint_terms": terms}
    log(f"sizing: {card}, total memory {total_memory}, budget {budget}, capacities {plan}, "
        f"footprint terms {terms}")
    if max_cap < SIZING_MIN_CAPACITY:
        raise AssertionError(f"the card's budget admits batch capacity {max_cap} only")

    def batches_of(cloud, cap):
        return list(BlockTiler(cloud, 0.01, 4.0, 0.4).batches(4, max_capacity=cap))

    def peak_of(fn):
        """(the peak bytes fn allocated above what was allocated before,
        the peak bytes allocated in all, seconds)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        return peak - base, peak, time.perf_counter() - t0

    gathers = []
    route3 = sparse_ops._gather_gemm

    def recorded_gather_gemm(feats, rulebook, weights, cfg, chunked):
        gathers.append((rulebook.shape[0], weights.shape[0] * weights.shape[1], chunked))
        return route3(feats, rulebook, weights, cfg, chunked)

    def one_batch(mi, vb):
        """vb (a device tiling's batch) alone through mi's culled path (run,
        collect), gathered afresh."""
        mi.plan_rows = []
        vb = tiler.TileBatch(vb.tiling, vb.blocks, vb.batch_size)
        mi._collect_culled(vb, mi._run_batch_culled(vb), ([], [], [], []))

    def model_peak(rows, t, in_flight=1):
        return estimate_forward_hbm(rows[0], planes, in_flight=in_flight, level_caps=rows,
                                    **t)["peak"]

    def held(what, mi, fn, batches, **head):
        """Run fn (mi's forward of `batches` batches) and hold its peak
        against the footprint model before headroom at the exact level rows
        of the largest plan it ran (`mi.plan_rows`, one per UNet pass). Every
        pass's model as the plan charges it (max_in_flight batches in
        flight) must fit mi's budget."""
        gathers.clear()
        sparse_ops._gather_gemm = recorded_gather_gemm
        try:
            measured, peak, dt = peak_of(fn)
        finally:
            sparse_ops._gather_gemm = route3
        runs = mi.plan_rows
        est = max(model_peak(rows, terms) for rows in runs)
        planned = max(model_peak(rows, mi.footprint_terms, max(1, mi.max_in_flight))
                      for rows in runs)
        jax_model = max(model_peak(rows, {}) for rows in runs) / 1.5   # the JAX terms
        row = {"case": what, **head, "precision": mi.precision,
               "measured_bytes": measured, "allocated_bytes": peak,
               "model_peak_bytes": est, "model_bytes": est / 1.5, "ratio": measured / est * 1.5,
               "jax_model_bytes": jax_model, "jax_ratio": measured / jax_model,
               "unet_passes": len(runs), "splits": len(runs) - batches,
               "largest_plan_rows": list(max(runs, key=sum)),
               "planned_peak_bytes": planned, "budget_bytes": mi.hbm_budget_bytes,
               "route3_gathers": len(gathers),
               "route3_chunked": sum(1 for *_, c in gathers if c),
               "largest_whole_gather_bytes": max(
                   [4 * m * w for m, w, c in gathers if not c], default=0),
               "seconds": dt}
        log(f"sizing {row}")
        # held to the model without its headroom: the 1.5x stays a margin
        if measured > est / 1.5:
            raise AssertionError(f"{what} {head} {mi.precision}: {measured} bytes, the model "
                                 f"{est / 1.5} before headroom")
        if planned > mi.hbm_budget_bytes:
            raise AssertionError(f"{what} {head} {mi.precision}: a pass planned at {planned} "
                                 f"bytes, past the budget {mi.hbm_budget_bytes}")
        return row

    # (b) the footprint at each capacity against the model: synthetic
    # batches in both layouts, then the bench tree's batches and the
    # forest's densest blocks alone, and a batch whose exact plan passes a
    # budget sized for its capacity, which splits
    rows = []
    cap = SIZING_MIN_CAPACITY
    largest = None
    while cap <= max_cap:
        voxels = int(SIZING_FILL * cap) // 4
        for layout in ("layers", "random"):
            cloud = dense_blocks(np, 4, voxels, seed=cap, layout=layout)
            (vb,) = batches_of(cloud, max_cap)
            if len(vb.coords) != cap or vb.n_valid != 4 * voxels:
                raise AssertionError(f"capacity {cap} {layout}: a batch of {len(vb.coords)} "
                                     f"rows holding {vb.n_valid} voxels, not {4 * voxels}")
            for mi in mis.values():
                row = held(layout, mi, lambda: mi.forward(cloud), 1, capacity=cap,
                           voxels=4 * voxels)
                rows.append(row)
                if cap == max_cap and layout == "layers":
                    for m, w, chunked in gathers:
                        if chunked != sparse_ops.ConvConfig().chunked(m, w):
                            raise AssertionError(f"route 3 at [{m}, {w}]: chunked {chunked}")
                        if not chunked and 4 * m * w > sparse_ops.CHUNK_BYTES:
                            raise AssertionError(f"route 3 gathered [{m}, {w}] whole")
            if layout == "layers":
                largest = vb
        cap *= 2
    forest = bench_scan.make_forest(FOREST_TREES, FOREST_POINTS_PER_M2)
    bench_tree = CentreCloud()(generate_tree(**BENCH_TREE)[0])
    q = np.floor(np.asarray(forest.xyz) / 4.0).astype(np.int64)
    _, inverse, block_points = np.unique(q, axis=0, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)
    dense = np.argsort(block_points)[::-1][:FOREST_DENSE_BLOCKS]
    def tile_batches_of(cloud, cap):
        return tiler.tile_cloud(cloud, 0.01, 4.0, 0.4, dev).batches(4, cap)

    real = [("bench_tree", vb) for vb in tile_batches_of(bench_tree, max_cap)]
    real += [("forest_dense_blocks", vb) for vb in
             tile_batches_of(forest.filter(np.isin(inverse, dense)), max_cap)]
    for what, vb in real:
        for mi in mis.values():
            row = held(what, mi, lambda: one_batch(mi, vb), 1,
                       capacity=vb.capacity, voxels=vb.rows)
            if row["unet_passes"] != 1:
                raise AssertionError(f"{what}: a batch took {row['unet_passes']} UNet passes")
            rows.append(row)
    voxels = int(SIZING_FILL * SIZING_MIN_CAPACITY) // 4
    cloud = dense_blocks(np, 4, voxels, seed=SIZING_MIN_CAPACITY, layout="random")
    small = ModelInference(WEIGHTS, precision="float32", medial_classes=(0,),
                           hbm_budget_bytes=estimate_forward_hbm(
                               SIZING_MIN_CAPACITY, planes, 1.0, in_flight=2, **terms)["peak"])
    row = held("random_split", small, lambda: small.forward(cloud), 1,
               capacity=SIZING_MIN_CAPACITY, voxels=4 * voxels)
    if small.max_batch_capacity != SIZING_MIN_CAPACITY or row["splits"] < 1:
        raise AssertionError(f"the split case planned {small.max_batch_capacity}, split "
                             f"{row['splits']} times")
    rows.append(row)
    result["footprint"] = rows
    del small, cloud

    # (c) two batches at the largest capacity, two in flight
    voxels = int(SIZING_FILL * max_cap) // 4
    cloud = dense_blocks(np, 8, voxels, seed=1)
    caps2 = [len(b.coords) for b in batches_of(cloud, max_cap)]
    if caps2 != [max_cap, max_cap]:
        raise AssertionError(f"two-batch cloud tiled into {caps2}")
    mi = mis["float32"]
    measured, peak, dt = peak_of(lambda: mi.forward(cloud))
    est = max(model_peak(r, terms, mi.max_in_flight) for r in mi.plan_rows)
    result["two_batches"] = {"capacities": caps2, "max_in_flight": mi.max_in_flight,
                             "plan_rows": mi.plan_rows,
                             "measured_bytes": measured, "allocated_bytes": peak,
                             "model_peak_bytes": est, "unet_passes": len(mi.plan_rows),
                             "seconds": dt}
    log(f"sizing two batches: {result['two_batches']}")
    if peak > budget or measured > est / 1.5:
        raise AssertionError(f"two batches in flight: {peak} bytes allocated, budget {budget}, "
                             f"the model's peak {est} (with its 1.5x headroom)")
    del cloud

    # (d) the slab kernel on level 0 of the largest batch's exact plan (bf16)
    mi16 = mis["bfloat16"]
    x, plan16, _ = mi16._plan_batch(largest)
    tall = {}
    for name, rb, lvl, cin, cout in unet_convs(plan16, planes):
        if name.startswith("L0.") and (
                (cin, cout) not in tall or rb.shape[0] > tall[cin, cout][1].shape[0]):
            tall[cin, cout] = (name, rb, plan16.levels[lvl].keys.shape[0])
    gen = torch.Generator(device=dev).manual_seed(20)
    slab_rows = []
    for (cin, cout), (name, rb, n) in sorted(tall.items()):
        feats = torch.randn((n, cin), generator=gen, device=dev)
        w = torch.randn((27, cin, cout), generator=gen, device=dev) / (27 * cin) ** 0.5
        got = slab_conv.slab_gather_conv(feats, rb, w)
        ref = slab_conv.slab_gather_conv_plain(feats, rb, w)
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, rtol=0, atol=SLAB_ATOL):
            raise AssertionError(f"slab kernel at M={rb.shape[0]} {name} ({cin}->{cout}): "
                                 f"max abs err {err}")
        del got, ref
        m = rb.shape[0]
        out = torch.empty((m, cout), dtype=torch.float32, device=dev)
        scratch = slab_conv._scratch(w)
        fe16 = torch.cat([feats, feats.new_zeros((1, cin))]).to(torch.bfloat16)
        idx = torch.where(rb >= 0, rb, n).long()
        w16 = w.to(torch.bfloat16).reshape(27 * cin, cout)
        b_ms, b_by = bound(rb, cin, cout, "bfloat16")
        row = {
            "conv": f"cap{largest.coords.shape[0]}.{name}", "cin": cin, "cout": cout,
            "m": m, "n": n, "max_abs_err": err,
            "ms": cuda_time_ms(torch, lambda: slab_conv.slab_gather_conv(feats, rb, w)),
            "kernel_ms": cuda_time_ms(torch, lambda: slab_conv._launch(feats, rb, w, scratch,
                                                                       out)),
            "plain_ms": cuda_time_ms(torch, lambda: slab_conv.slab_gather_conv_plain(
                feats, rb, w)),
            "library_ms": cuda_time_ms(torch, lambda: torch.matmul(fe16[idx].view(m, -1), w16)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        log(f"slab at the card's capacity {name} {cin}->{cout} M={m}: {row}")
        slab_rows.append(row)
        del feats, w, out, scratch, fe16, idx, w16
    if not slab_rows:
        raise AssertionError("no level-0 conv of the largest batch reaches the slab kernel")
    del x, plan16, largest

    # (e) the card's plan against the old ceiling: the bench tree and the
    # forest keep their batches (equal plans, no forward needed); four dense
    # blocks of a 1,048,576-voxel batch ship one a batch under the old
    # ceiling, and give the same fp32 predictions
    agreement = {}
    first = np.flatnonzero(block_points > 20)[:FOREST_COMPARE_BLOCKS]   # BlockTiler's order
    forest16 = forest.filter(np.isin(inverse, first))
    del forest, q, inverse
    for what, cloud in (("bench_tree", bench_tree), ("forest_first_blocks", forest16)):
        plans = [[len(b.coords) for b in batches_of(cloud, c)] for c in (max_cap, OLD_CEILING)]
        if plans[0] != plans[1]:
            raise AssertionError(f"{what}: the card's plan {plans[0]} differs from the old "
                                 f"ceiling's {plans[1]}")
        agreement[what] = {"points": len(cloud), "card_plan": plans[0],
                           "old_ceiling_plan": plans[1]}
    dense_cap = min(max_cap, 1 << 20)
    cloud = dense_blocks(np, 4, int(SIZING_FILL * dense_cap) // 4, seed=3)
    card_mi = ModelInference(WEIGHTS, precision="float32")
    old_mi = ModelInference(WEIGHTS, precision="float32")
    old_mi.max_batch_capacity = OLD_CEILING
    outs, plans = [], []
    for mi in (card_mi, old_mi):
        plans.append([len(b.coords) for b in batches_of(cloud, mi.max_batch_capacity)])
        out = mi.predict(cloud)
        order = np.lexsort(np.concatenate([out["xyz"], out["rgb"]], axis=1).T)
        outs.append({k: v[order] for k, v in out.items()})
    got, ref = outs
    np.testing.assert_array_equal(got["xyz"], ref["xyz"])
    for k in ("radius", "direction", "class_logits"):
        np.testing.assert_allclose(got[k], ref[k], **MODEL_TOL, err_msg=f"dense_blocks {k}")
    agree = float((got["class_logits"].argmax(1) == ref["class_logits"].argmax(1)).mean())
    agreement["dense_blocks"] = {"points": len(cloud), "voxels": len(got["xyz"]),
                                 "card_plan": plans[0], "old_ceiling_plan": plans[1],
                                 "class_agreement": agree}
    log(f"sizing plans: {agreement}")
    if plans[0] == plans[1]:
        raise AssertionError("the dense blocks' batches are the same under the old ceiling")
    result["plans"] = agreement
    result["phase_s"] = time.perf_counter() - t_phase
    return result, slab_rows


def bench_convs(mi16, batches):
    """Every 27-column conv of the bench tree's batches on their exact
    plans: (name, rulebook, table rows, Cin, Cout)."""
    convs = []
    for vb in batches:
        x, plan, _ = mi16._plan_batch(vb)
        rows = [lv.keys.shape[0] for lv in plan.levels]
        log(f"batch capacity {len(vb.coords)}: exact level rows {rows}")
        convs += [(f"cap{len(vb.coords)}.{name}", rb, plan.levels[lvl].keys.shape[0],
                   cin, cout)
                  for name, rb, lvl, cin, cout in unet_convs(plan, mi16.model.unet_planes)]
    return convs


def dispatch_crossover(torch, np, convs, max_rows: int, card):
    """Phase 3 (b): the hand kernels against route 3 over row counts. Per
    (Cin, Cout) of the bench model, the tallest bench rulebook of that pair
    is tiled (copy j reads its own copy of the table) to every row count of
    CROSSOVER_ROWS up to `max_rows`; at each, B1 and route 3 at bf16 and,
    while the table holds at most CROSSOVER_TABLE_BYTES, B2 and route 3 at
    fp32, each the median of 20 event-timed calls after 3 warm-ups, and
    each kernel held against its plain version (every row count: ragged, M
    not a multiple of the 128-row tile, and M < 128). Returns the rows and,
    per pair, the smallest row count from which each kernel is faster at
    every count measured."""
    from smart_tree_tpu_torch.core import fused_conv, slab_conv, sparse_ops

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(30)
    tallest = {}
    for _, rb, n, cin, cout in convs:
        if (cin, cout) not in tallest or rb.shape[0] > tallest[cin, cout][0].shape[0]:
            tallest[cin, cout] = (rb, n)
    rows_out, summary = [], {}

    def crossover_ms(fn):
        return median_ms(torch, fn, repeats=20, warmup=3)

    def held(got, plain, rb, what, tol):
        """got against `plain` over row blocks (the plain gather of a tall
        rulebook would not fit): the largest abs error."""
        err = 0.0
        for r in range(0, rb.shape[0], CROSSOVER_CHECK_ROWS):
            ref = plain(rb[r : r + CROSSOVER_CHECK_ROWS])
            part = got[r : r + CROSSOVER_CHECK_ROWS]
            err = max(err, float((part - ref).abs().max()))
            if not torch.allclose(part, ref, **tol):
                raise AssertionError(f"{what} at M={rb.shape[0]}: max abs err {err}")
        return err

    for (cin, cout), (rb0, n0) in sorted(tallest.items()):
        m0 = rb0.shape[0]
        w = torch.randn((27, cin, cout), generator=gen, device=dev) / (27 * cin) ** 0.5
        pair = []
        for m in (r for r in CROSSOVER_ROWS if r <= max_rows):
            copies = -(-m // m0)
            base = rb0.repeat(copies, 1)[:m]
            off = (torch.arange(copies, device=dev, dtype=torch.int32) * n0) \
                .repeat_interleave(m0)[:m, None]
            rb = torch.where(base >= 0, base + off, -1).to(torch.int32).contiguous()
            feats = torch.randn((copies * n0, cin), generator=gen, device=dev)
            cfg16, cfg32 = sparse_ops.ConvConfig("bfloat16"), sparse_ops.ConvConfig("float32")
            chunked = cfg16.chunked(m, 27 * cin)
            row = {"cin": cin, "cout": cout, "m": m, "route3_chunked": chunked}
            got = slab_conv.slab_gather_conv(feats, rb, w)
            row["b1_err"] = held(got, lambda r: slab_conv.slab_gather_conv_plain(feats, r, w),
                                 rb, f"slab kernel {cin}->{cout}", dict(rtol=0, atol=SLAB_ATOL))
            del got
            row["b1_ms"] = crossover_ms(lambda: slab_conv.slab_gather_conv(feats, rb, w))
            row["route3_bf16_ms"] = crossover_ms(
                lambda: sparse_ops._gather_gemm(feats, rb, w, cfg16, chunked))
            if m * cin * 4 <= CROSSOVER_TABLE_BYTES:
                got = fused_conv.fused_gather_gemm(feats, rb, w)
                row["b2_err"] = held(got, lambda r: fused_conv.fused_gather_gemm_plain(
                    feats, r, w), rb, f"fused kernel {cin}->{cout}", FUSED_TOL)
                del got
                row["b2_ms"] = crossover_ms(lambda: fused_conv.fused_gather_gemm(feats, rb, w))
                row["route3_fp32_ms"] = crossover_ms(
                    lambda: sparse_ops._gather_gemm(feats, rb, w, cfg32, chunked))
            log(f"crossover {row}")
            pair.append(row)
            del rb, feats, base, off
        for kernel, plain in (("b1", "route3_bf16"), ("b2", "route3_fp32")):
            timed = [r for r in pair if f"{kernel}_ms" in r]
            wins = [r[f"{kernel}_ms"] < r[f"{plain}_ms"] for r in timed]
            # the smallest row count from which the kernel wins at every count
            start = next((i for i in range(len(wins)) if all(wins[i:])), None)
            summary.setdefault(f"{cin}->{cout}", {})[f"{kernel}_faster_from_rows"] = (
                None if start is None else timed[start]["m"])
            summary[f"{cin}->{cout}"][f"{kernel}_wins_at_every_count"] = all(wins)
        rows_out += pair
    torch.cuda.empty_cache()
    return {"card": card, "rows": rows_out, "by_pair": summary,
            "seconds": time.perf_counter() - t0}


def checked_unet(mi):
    """Wrap mi._unet so that every pass checks its plan: each level's keys,
    mask and rulebooks exactly its voxel count long, every key valid, every
    rulebook entry a row of its table, and the input at level 0's rows.
    Reads each count: never in a timed forward. Undo with `del mi._unet`."""
    unet = mi._unet

    def check(x, plan):
        levels = plan.levels
        if x.feats.shape[0] != levels[0].keys.shape[0]:
            raise AssertionError(f"input rows {x.feats.shape[0]}, level 0 {levels[0].keys.shape}")
        for lvl, lv in enumerate(levels):
            n = lv.keys.shape[0]
            if int(lv.count) != n or lv.active.shape[0] != n or not bool(lv.active.all()):
                raise AssertionError(f"level {lvl}: {n} rows, count {int(lv.count)}")
            tables = [(lv.subm_rb, n, n)]
            if lv.down_rb is not None:
                n_next = levels[lvl + 1].keys.shape[0]
                tables += [(lv.down_rb, n_next, n), (lv.up_rb, n, n_next)]
            for rb, rows, table in tables:
                if rb.shape != (rows, 27) or int(rb.max()) >= table or int(rb.min()) < -1:
                    raise AssertionError(f"level {lvl}: a rulebook of {tuple(rb.shape)} over "
                                         f"{table} rows, the level holds {rows}")
        return unet(x, plan)

    mi._unet = check


def exact_plan_phase(torch, np, card, forest_scan=None):
    """Phase 21: exact plans on the card. (a) the bench tree at bf16 through
    the full download (`predicted`) and the forward without and with the
    cull: one UNet pass a batch, every plan tensor at its level's count
    (`checked_unet`), B1 launches a forward, the forward's seconds (median
    of 5), the device-busy share of one profiled forward and
    the peak allocated bytes against the footprint model at the exact
    counts; (b) at fp32 each bench batch's exact-plan forward against the
    same batch through static plans at capacities that do not overflow (the
    trainer's form), route 3 on every conv of both; (c) the bf16 classes
    against fp32's; (d) fp32 on the card against the CPU on the small tree;
    (e) the forest's densest blocks, one pass a batch, beside the passes of
    phase 17's whole forest scan. Returns the `exact_plans` line."""
    from smart_tree_tpu_torch.bench import _profiled_forward, kernel_busy_s
    from smart_tree_tpu_torch.core import fused_conv, slab_conv
    from smart_tree_tpu_torch.core.coords import INVALID_KEY
    from smart_tree_tpu_torch.core.memory import estimate_forward_hbm
    from smart_tree_tpu_torch.core.plan import build_plan
    from smart_tree_tpu_torch.core.sparse_ops import ConvConfig
    from smart_tree_tpu_torch.core.sparse_tensor import SparseVoxelTensor
    from smart_tree_tpu_torch.data.augmentations import CentreCloud
    from smart_tree_tpu_torch.data.dataset import BlockTiler
    from smart_tree_tpu_torch.data.synthetic import generate_tree
    from smart_tree_tpu_torch.infer.inference import ModelInference
    from smart_tree_tpu_torch.tools import bench_scan

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    cloud = CentreCloud()(generate_tree(**BENCH_TREE)[0])
    result = {"card": card, "modes": {}}

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) the three modes at bf16
    outs = {}
    for mode, kw in (("full", {}), ("compact", {}), ("culled", dict(medial_classes=[0]))):
        mi = ModelInference(WEIGHTS, batch_size=4, precision="bfloat16", **kw)
        if mode == "full":
            predicted(np, mi)
        batches = [len(b.coords) for b in BlockTiler(cloud, 0.01, 4.0, 0.4).batches(
            4, max_capacity=mi.max_batch_capacity)]
        checked_unet(mi)
        mi.forward(cloud)   # also the warm-up
        del mi._unet
        if len(mi.plan_rows) != len(batches):
            raise AssertionError(f"{mode}: {len(mi.plan_rows)} UNet passes for "
                                 f"{len(batches)} batches")
        slab_conv.slab_gather_conv.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, _ = synced(lambda: mi.forward(cloud))
        measured = torch.cuda.max_memory_allocated() - base
        launches = slab_conv.slab_gather_conv.launches
        if launches == 0:
            raise AssertionError(f"{mode}: the bf16 forward never launched the slab kernel")
        est = max(estimate_forward_hbm(r[0], mi.model.unet_planes, level_caps=r,
                                       in_flight=mi.max_in_flight, **mi.footprint_terms)["peak"]
                  for r in mi.plan_rows)
        if measured > est / 1.5:
            raise AssertionError(f"{mode}: {measured} bytes allocated, the model at the exact "
                                 f"counts {est / 1.5} before headroom")
        seconds = sorted(synced(lambda: mi.forward(cloud))[1] for _ in range(5))
        wall, events = _profiled_forward(mi, cloud, dev, None)
        busy = kernel_busy_s(events)
        result["modes"][mode] = {
            "batch_capacities": batches, "plan_rows": mi.plan_rows,
            "unet_passes": len(mi.plan_rows), "slab_launches_per_forward": launches,
            "forward_s": seconds, "forward_median_s": seconds[2],
            "profiled_wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "peak_bytes": measured, "model_peak_bytes": est, "ratio": measured / est * 1.5,
        }
        log(f"exact plans {mode}: {result['modes'][mode]}")
        outs[mode] = out
    for mode in ("compact", "culled"):
        if not np.array_equal(outs[mode].xyz, outs["full"].xyz):
            raise AssertionError(f"{mode}: other rows than the full download's")

    # (b) fp32: exact plans against static plans that do not overflow
    mi32 = ModelInference(WEIGHTS, batch_size=4, precision="float32")
    model, levels = mi32.model, len(mi32.model.unet_planes)
    slab_conv.slab_gather_conv.launches = fused_conv.fused_gather_gemm.launches = 0
    static_err = {}
    with torch.no_grad():
        for vb in BlockTiler(cloud, 0.01, 4.0, 0.4).batches(
                4, max_capacity=mi32.max_batch_capacity):
            x, plan, _ = mi32._plan_batch(vb)
            n, cap = x.capacity, len(vb.coords)
            exact = model(plan, x.feats, ConvConfig("float32"))
            keys = torch.cat([x.keys, x.keys.new_full((cap - n,), INVALID_KEY)])
            feats = torch.cat([x.feats, x.feats.new_zeros((cap - n, x.feats.shape[1]))])
            xs = SparseVoxelTensor(keys, feats, keys != INVALID_KEY, x.spatial_shape,
                                   x.batch_size)
            caps = (cap, *(max(256, 1 << (lv.keys.shape[0] - 1).bit_length())
                           for lv in plan.levels[1:]))
            splan = build_plan(xs, levels, level_capacities=caps)
            if any(int(lv.count) > lv.keys.shape[0] for lv in splan.levels):
                raise AssertionError(f"the static plan at {caps} overflowed")
            static = model(splan, xs.feats, ConvConfig("float32"))
            for k in ("radius", "direction", "class_l"):
                a, b = exact[k], static[k][:n]
                static_err[k] = max(static_err.get(k, 0.0), float((a - b).abs().max()))
                if not torch.allclose(a, b, **MODEL_TOL):
                    raise AssertionError(f"fp32 exact against static plan at {caps}, {k}: "
                                         f"max abs err {static_err[k]}")
    if slab_conv.slab_gather_conv.launches or fused_conv.fused_gather_gemm.launches:
        raise AssertionError("a hand kernel ran in the fp32 exact / static comparison")
    result["fp32_exact_vs_static_max_abs_err"] = static_err

    # (c) bf16 classes against fp32's, on the same rows
    out32 = mi32.predict(cloud)
    np.testing.assert_array_equal(outs["full"].xyz, out32["xyz"])
    agree = float((outs["full"].class_l[:, 0] == out32["class_logits"].argmax(1)).mean())
    result["class_agreement_bf16_vs_fp32"] = agree
    if agree < 0.99:
        raise AssertionError(f"bf16 against fp32 class agreement {agree}")

    # (d) fp32 on the card against the CPU on the small tree
    small = CentreCloud()(generate_tree(**SMALL_TREE)[0])
    got = ModelInference(WEIGHTS, precision="float32").predict(small)
    ref = ModelInference(WEIGHTS, precision="float32", device="cpu").predict(small)
    np.testing.assert_array_equal(got["xyz"], ref["xyz"])
    for k in ("radius", "direction", "class_logits"):
        np.testing.assert_allclose(got[k], ref[k], **MODEL_TOL, err_msg=k)

    # (e) the forest's densest blocks, culled bf16
    forest = bench_scan.make_forest(FOREST_TREES, FOREST_POINTS_PER_M2)
    q = np.floor(np.asarray(forest.xyz) / 4.0).astype(np.int64)
    _, inverse, block_points = np.unique(q, axis=0, return_inverse=True, return_counts=True)
    dense = np.argsort(block_points)[::-1][:FOREST_DENSE_BLOCKS]
    forest = forest.filter(np.isin(inverse.reshape(-1), dense))
    mi = ModelInference(WEIGHTS, batch_size=4, precision="bfloat16", medial_classes=[0])
    n_batches = len(list(BlockTiler(forest, 0.01, 4.0, 0.4).batches(
        4, max_capacity=mi.max_batch_capacity)))
    checked_unet(mi)
    out, dt = synced(lambda: mi.forward(forest))
    del mi._unet
    if len(mi.plan_rows) != n_batches or not np.isfinite(out.medial_vector).all():
        raise AssertionError(f"forest dense blocks: {len(mi.plan_rows)} passes for {n_batches} "
                             "batches, or a non-finite output")
    result["forest_dense_blocks"] = {"points": len(forest), "batches": n_batches,
                                     "unet_passes": len(mi.plan_rows),
                                     "plan_rows": mi.plan_rows, "forward_s": dt}
    if forest_scan is not None:   # phase 17's whole forest, one forward
        result["forest_scan"] = {"batches": forest_scan["host_tiling"]["batches"],
                                 "unet_passes": forest_scan["unet_passes"]}
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"exact plans: {result}")
    return result


def count_bound(n: int, m: int, dst_is_src: bool, pairs: int) -> tuple:
    """(ms, "bytes" or "operations"): the least time for the radius count of
    n queries against m points. Bytes: each distinct input read once (a
    query's point 12 bytes, radius 4, mask 1; the dst points 12 and mask 1
    only where they are other tensors than the queries) and the two int32
    counts (8) written once, over the card's memory rate. Operations: the
    pairs this run's data needs, at least `possible` of them a row (each
    counted pair is compared), 10 fp32 operations a pair (three differences,
    three squares, two sums, two comparisons) over the fp32 peak."""
    t_bytes = (25 * n + (0 if dst_is_src else 13 * m)) / HBM_BYTES_PER_S * 1e3
    t_ops = 10.0 * pairs / PEAK_FLOPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def radius_count_phase(torch, np, card, clouds):
    """Phase 22: the cell-sorted radius count (neighbors/grid_count.py, the
    CUDA kernel csrc/radius_count.cu) on the skeleton stage's own inputs,
    `clouds` = {name: (medial points, predicted radii)} on the host (the bench
    tree's and the forest scan's branch points), radii clamped at
    MIN_FILTER_RADIUS as the skeletonizer clamps them. For each: two kernel
    launches and the plain version on the card, equal int32 bits; the new
    shell and its `_exact_keep`; the wrapper, the bare kernel, the plain
    version, `_exact_keep` on the shell and `outlier_removal` as a whole
    timed by CUDA events; the bound; the count on cells of the largest reach
    (grid_knn's edge, set by patching `grid_count._edge`) in place of the
    median: the same counts, and its time.
    On the bench tree also the JAX
    formulation the filter used before, `knn.radius_count`, its shell and
    its `_exact_keep` (the forest's takes some 30 s: scripts/profile_filter.py
    measures it). Returns (the `radius_count` line, the kernel's rows)."""
    from smart_tree_tpu_torch.neighbors import grid_count
    from smart_tree_tpu_torch.neighbors.knn import radius_count
    from smart_tree_tpu_torch.skeleton import filter as filter_mod

    t_phase = time.perf_counter()
    rows = []
    for name, (pts_h, radii_h) in clouds.items():
        pts = torch.from_numpy(np.ascontiguousarray(pts_h, np.float32)).cuda()
        radii = torch.from_numpy(np.ascontiguousarray(radii_h, np.float32)).cuda().reshape(-1)
        radii = radii.clamp_min(MIN_FILTER_RADIUS)
        valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
        args = (pts, pts, radii, valid, valid)
        n = pts.shape[0]

        def count():
            return grid_count.grid_radius_count(*args, cap=NB_POINTS)

        got, again = count(), count()
        ref = grid_count.grid_radius_count_plain(*args, cap=NB_POINTS)
        torch.cuda.synchronize()
        for a, b, c, what in zip(got, again, ref, ("certain", "possible")):
            if not (torch.equal(a, b) and torch.equal(a, c)):
                raise AssertionError(f"{name}: the count kernel's {what} differs between two "
                                     "launches or from its plain version")
        err = max(int((a - c).abs().max()) for a, c in zip(got, ref))
        # the same count on cells of the largest reach, grid_knn's choice of
        # edge: other cells, the same counts
        g = grid_count.build_grid(*args)
        wide = float(g.reach.max())
        median_edge = grid_count._edge
        grid_count._edge = lambda reach, counted, extent: wide
        try:
            if float(grid_count.build_grid(*args).cell) != float(
                    torch.tensor(wide, dtype=torch.float32)):
                raise AssertionError(f"{name}: the patched cell edge was not used")
            if not all(torch.equal(a, b) for a, b in zip(got, count())):
                raise AssertionError(f"{name}: the count differs on cells of the largest reach")
            wide_ms = cuda_time_ms(torch, count, iters=3, warmup=1)
        finally:
            grid_count._edge = median_edge
        certain, possible = got
        bound_ms, bound_by = count_bound(n, n, True, int(possible.sum()))
        sure = certain >= NB_POINTS
        shell = torch.nonzero((possible >= NB_POINTS) & ~sure).squeeze(1)
        order = grid_count._query_order(pts, g)
        out = (torch.empty_like(certain), torch.empty_like(certain))
        slow = 2 if name == "forest" else 5   # the plain version takes seconds there
        row = {
            "cloud": name, "n": n, "cell_m": float(g.cell), "grid": list(g.dims),
            "shell_rows": int(shell.numel()), "sure_rows": int(sure.sum()),
            "max_abs_err": err,
            "ms": cuda_time_ms(torch, count, iters=10, warmup=1),
            "widest_cell_m": wide,
            "widest_cell_ms": wide_ms,
            "kernel_ms": cuda_time_ms(torch, lambda: grid_count._launch(
                pts, order, g, NB_POINTS, *out), iters=10, warmup=1),
            "plain_ms": cuda_time_ms(torch, lambda: grid_count.grid_radius_count_plain(
                *args, cap=NB_POINTS), iters=slow, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "exact_keep_ms": cuda_time_ms(torch, lambda: filter_mod._exact_keep(
                pts, radii, pts[shell], radii[shell], NB_POINTS, valid), iters=3, warmup=1)
            if shell.numel() else 0.0,
            "filter_ms": cuda_time_ms(torch, lambda: filter_mod.outlier_removal(
                pts, radii, NB_POINTS), iters=3, warmup=1),
        }
        if name == "bench":
            lo, hi = radius_count(*args, cap=NB_POINTS)
            old = torch.nonzero((hi >= NB_POINTS) & ~(lo >= NB_POINTS)).squeeze(1)
            row.update(
                radius_count_ms=cuda_time_ms(torch, lambda: radius_count(
                    *args, cap=NB_POINTS), iters=3, warmup=1),
                radius_count_shell_rows=int(old.numel()),
                radius_count_exact_keep_ms=cuda_time_ms(torch, lambda: filter_mod._exact_keep(
                    pts, radii, pts[old], radii[old], NB_POINTS, valid), iters=3, warmup=1),
            )
        log(f"radius count {name}: {row} ({card})")
        rows.append(row)
        del pts, radii, valid, args, got, again, ref, g, order, out
    torch.cuda.empty_cache()
    return {"card": card, "clouds": rows, "phase_s": time.perf_counter() - t_phase}, rows


TRACER_KERNELS = ("seed_trace_kernel", "select_kernel", "write_path_kernel")


def tracer_phase(torch, card, inputs, hop_cap: int, max_branches: int) -> dict:
    """Phase 23: the branch tracer (skeleton/path.py, the kernels of
    csrc/tracer.cu) on the inputs phase 8's timed pipeline run handed
    `sample_forest` on the bench tree. The greedy loop through `_rounds`
    once with the kernels (`greedy_steps`) and once with `greedy_step_plain`,
    both on the card: the fetched headers and parents, and the state after
    the last round (dist, allocated, branch_ids, path_branch, path_pos,
    parents, the header), equal bit for bit. Then, per real greedy
    iteration: `ms`, the wrapper (`sample_tree_device` as a whole, jump
    tables included; the host's clock around a synchronised card, the best
    of three); `kernel_ms`, the three kernels' device time under
    torch.profiler, those of queued iterations past the end included as far
    as the profiler records them; `plain_ms`,
    the plain step on the card (the equality run); `bound_ms`, dist read
    twice (the seed's max and the select's validity test, 8 bytes a vertex)
    at the card's memory rate. No library call does a greedy iteration.
    Returns the kernel's row."""
    from smart_tree_tpu_torch.skeleton import path as tpath

    t_phase = time.perf_counter()

    def plain_steps(tr, steps):
        for _ in range(steps):
            tpath.greedy_step_plain(tr)

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    def run():
        return tpath.sample_tree_device(*inputs, hop_cap, max_branches)

    runs = {}
    for route, steps in (("kernels", tpath.greedy_steps), ("plain", plain_steps)):
        tr = tpath._tracer_state(*inputs, hop_cap, max_branches)
        stats = {}
        t0 = synced()
        hdr, parents = tpath._rounds(tr, steps, stats)
        runs[route] = tr, hdr, parents, stats["tracer_fetches"], synced() - t0
    (a, hdr, parents, fetches, _), (b, hdr_b, parents_b, fetches_b, plain_s) = \
        runs["kernels"], runs["plain"]
    if (hdr, parents, fetches) != (hdr_b, parents_b, fetches_b):
        raise AssertionError(f"tracer: header {hdr}, {fetches} fetches with the kernels; "
                             f"{hdr_b}, {fetches_b} with the plain step")
    for name in ("dist", "allocated", "branch_ids", "path_branch", "path_pos", "parents",
                 "header"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"tracer: {name} differs between the kernels and the plain step")
    iters = hdr[tpath.ITERS]
    if iters < 2 or not hdr[tpath.NO_WORK]:
        raise AssertionError(f"tracer: the bench tree's loop ended at header {hdr}")
    del a, b, runs
    wrapper = []
    for _ in range(3):
        t0 = synced()
        run()
        wrapper.append(synced() - t0)
    tpath.greedy_steps.launches = 0
    prof = kernel_ms_in(torch, run, TRACER_KERNELS)
    launches = tpath.greedy_steps.launches
    # every launch of a real iteration, and no other kernel: CUPTI may drop
    # some of the queued no-op launches past the end (a microsecond each)
    if any(not iters <= seen <= launches // 3 for _, seen in prof.values()):
        raise AssertionError(f"profiler saw {prof} tracer kernels, the wrapper counted "
                             f"{launches} launches for {iters} iterations")
    n = int(inputs[0].shape[0])
    row = {
        "cloud": "bench", "vertices": n, "hop_cap": hop_cap, "iterations": iters, "queued_iterations": launches // 3,
        "branches": hdr[tpath.COUNT], "fetches": fetches, "max_abs_err": 0,
        "ms": 1e3 * min(wrapper) / iters,
        "kernel_ms": sum(ms for ms, _ in prof.values()) / iters,
        "kernel_ms_a_launch": {k: ms / seen for k, (ms, seen) in prof.items()},
        "profiled_launches": {k: seen for k, (_, seen) in prof.items()},
        "plain_ms": 1e3 * plain_s / iters,
        "bound_ms": 8.0 * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "wrapper_s": wrapper, "plain_s": plain_s,
        "phase_s": time.perf_counter() - t_phase,
    }
    log(f"tracer: {row} ({card})")
    return row


TILER_KERNELS = ("tiler_bin", "tiler_slab_count", "tiler_scan", "tiler_slab_fill",
                 "tiler_slab_sort", "tiler_slab_emit", "tiler_gather")


def tiler_phase(torch, np, card) -> dict:
    """Phase 24: the forward's device tiler (core/tiler.py, the kernels of
    csrc/tiler.cu) on the bench tree and the benchmark's forest
    (`make_forest(6, 8000, 0)`), block 4 m, buffer 0.4 m, voxel 1 cm, batches
    of 4 at `ModelInference`'s bf16 capacity. For each cloud:
      (a) the kernels against the plain version (CPU tensors): every array of
          the tiling and every batch's gather, int8 and fp16 residuals, bit
          for bit;
      (b) the kernels against the host path the forward used before:
          `BlockTiler` batches, each batch's `key_order` and `_stage_sorted`
          (int8), keys, residuals, interior bits, origins and capacities;
      (c) a cloud's `ms`: tile_cloud, the grouping and one slot-table upload
          and gather a batch, the host's clock around a synchronised card
          (best of 5); `kernel_ms`: the same work's launches queued without
          the host reads (the two steps, then every batch's gather, scratch
          allocation included), timed by CUDA events (mean of 20), and the
          kernels' split under torch.profiler where it records every launch
          (`kernel_ms_by_kernel`, None where it does not: in the whole smoke
          it dropped most of them); `host_ms`: the yardstick, BlockTiler with its
          batches and each batch's key_order and _stage_sorted (best of 3);
          `plain_ms`: the plain version on the CPU (best of 2); `bound_ms`:
          the bytes the work needs at the card's memory rate (the points read
          once, 12 B; the tiling written once, 9 B a voxel; each gathered row
          read, 9 + 12 B, and written, 16 B); launches and host reads a
          cloud.
    Then (d) the bf16 forward of the bench tree launches the tiler's
    kernels. Returns the phase's line."""
    from smart_tree_tpu_torch.core import tiler
    from smart_tree_tpu_torch.data import dataset as tds
    from smart_tree_tpu_torch.data.augmentations import CentreCloud
    from smart_tree_tpu_torch.data.dataset import BlockTiler
    from smart_tree_tpu_torch.data.synthetic import generate_tree
    from smart_tree_tpu_torch.infer.inference import ModelInference
    from smart_tree_tpu_torch.tools.bench_scan import make_forest

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    grid = (0.01, 4.0, 0.4)
    mi = ModelInference(WEIGHTS, precision="bfloat16", medial_classes=(0,))
    cap = mi.max_batch_capacity

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    def device_tiling(device):
        stats = {}
        t = tiler.tile_cloud(cloud, *grid, device, stats=stats)
        batches = t.batches(4, cap)
        inputs = [tiler.gather(b, torch.from_numpy(b.table()).to(device), True)
                  for b in batches]
        return t, batches, inputs, stats

    def host_path():
        out = []
        for vb in BlockTiler(cloud, *grid).batches(4, max_capacity=cap):
            keys, order, n_act = vb.key_order()
            out.append((vb, vb._stage_sorted(keys, order, n_act, 4096, np.int8)))
        return out

    rows = []
    for name, cloud in (("bench", CentreCloud()(generate_tree(**BENCH_TREE)[0])),
                        ("forest", make_forest(FOREST_TREES, FOREST_POINTS_PER_M2, 0))):
        got, batches, inputs, stats = device_tiling(dev)
        ref, ref_batches, ref_inputs, _ = device_tiling(torch.device("cpu"))
        # (a) kernels against the plain version
        for field in ("origins", "key", "first", "interior", "vstart"):
            if not torch.equal(getattr(got, field).cpu(), getattr(ref, field)):
                raise AssertionError(f"tiler {name}: {field} differs from the plain version")
        if not (np.array_equal(got.counts, ref.counts)
                and np.array_equal(got.interior_counts, ref.interior_counts)
                and got.box_tests == ref.box_tests
                and [b.blocks.tolist() for b in batches]
                == [b.blocks.tolist() for b in ref_batches]):
            raise AssertionError(f"tiler {name}: counts, tests or batches differ")
        for b, rb in zip(batches, ref_batches):
            for int8 in (True, False):
                a = tiler.gather(b, torch.from_numpy(b.table()).to(dev), int8)
                c = tiler.gather(rb, torch.from_numpy(rb.table()), int8)
                for x, y, what in zip(a, c, ("keys", "res", "interior", "index", "origins")):
                    if not torch.equal(x.cpu(), y):
                        raise AssertionError(f"tiler {name}: a batch's {what} (int8 {int8}) "
                                             "differs from the plain version")
        # (b) kernels against the host path
        host = host_path()
        if [vb.capacity for vb, _ in host] != [b.capacity for b in batches]:
            raise AssertionError(f"tiler {name}: capacities differ from the host tiler's")
        for (vb, (skeys, res, orig, n_act, bits)), (keys, r, interior, _, origins) in zip(
                host, inputs):
            same = (np.array_equal(keys.cpu().numpy(), skeys[:n_act].astype(np.int64))
                    and np.array_equal(r.cpu().numpy(), res[:n_act])
                    and np.array_equal(interior.cpu().numpy(),
                                       np.unpackbits(bits, count=n_act).astype(bool))
                    and np.array_equal(origins.cpu().numpy(), orig))
            if not same:
                raise AssertionError(f"tiler {name}: a batch differs from the host path")
        # (c) times
        del ref_inputs
        tiler.tile_cloud.launches = tiler.gather.launches = 0
        wall = []
        for _ in range(5):
            t0 = synced()
            device_tiling(dev)
            wall.append(synced() - t0)
        launches = (tiler.tile_cloud.launches + tiler.gather.launches) // 5
        xyz = torch.from_numpy(got.xyz).to(dev)
        ids = torch.from_numpy(tds.kept_blocks(got.xyz, grid[1])).to(dev)
        faces = tiler.Faces.of(grid[1], grid[2])
        bits = tiler.key_bits(got.grid_shape, 1)[1]
        halo = got.box_tests and int(tiler._CudaSteps(xyz, ids, faces, grid[0], got.side,
                                                       bits).bin()[1])
        tables = [torch.from_numpy(b.table()).to(dev) for b in batches]

        def queued():
            work = tiler._CudaSteps(xyz, ids, faces, grid[0], got.side, bits)
            work.bin()
            work.sort(halo)
            for b, table in zip(batches, tables):
                tiler.gather(b, table, True)

        queued_ms = cuda_time_ms(torch, queued)
        expected = dict.fromkeys(TILER_KERNELS, 1)
        expected.update(tiler_scan=2, tiler_gather=len(batches))
        try:
            prof = kernel_ms_in(torch, lambda: device_tiling(dev), TILER_KERNELS)
        except AssertionError as e:   # CUPTI gave no device time in this process
            log(f"tiler {name}: {e}")
            prof = {}
        by_kernel = {k: ms for k, (ms, _) in prof.items()}
        if any(prof.get(k, (0, 0))[1] < n for k, n in expected.items()):
            # late in a long process CUPTI has dropped launches: no split
            log(f"tiler {name}: the profiler saw {prof}; the split by kernel is not measured")
            by_kernel = None
        host_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            host_path()
            host_s.append(time.perf_counter() - t0)
        plain_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            device_tiling(torch.device("cpu"))
            plain_s.append(time.perf_counter() - t0)
        n, m = len(cloud), len(got.key)
        gathered = sum(b.rows for b in batches)
        nbytes = 12 * n + 9 * m + (9 + 12 + 16) * gathered
        row = {
            "cloud": name, "points": n, "blocks": len(got.counts), "voxels": m,
            "batches": len(batches), "box_tests": got.box_tests, "max_abs_err": 0,
            "ms": 1e3 * min(wall),
            "kernel_ms": queued_ms,
            "kernel_ms_by_kernel": by_kernel,
            "profiled_launches": {k: c for k, (_, c) in prof.items()},
            "host_ms": 1e3 * min(host_s),
            "plain_ms": 1e3 * min(plain_s),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bound_bytes": nbytes, "library_ms": None,
            "launches": launches, "fetches": stats["tile_fetches"],
            "wall_s": wall, "host_s": host_s, "plain_s": plain_s,
        }
        log(f"tiler: {row} ({card})")
        rows.append(row)
        del got, ref, batches, ref_batches, inputs, host
    # (d) the forward on the main path launches the kernels
    cloud = CentreCloud()(generate_tree(**BENCH_TREE)[0])
    tiler.tile_cloud.launches = tiler.gather.launches = 0
    stats = {}
    mi.forward(cloud, stats=stats)
    forward = {"tile_launches": tiler.tile_cloud.launches,
               "gather_launches": tiler.gather.launches,
               "tile_fetches": stats["tile_fetches"], "tile_box_tests": stats["tile_box_tests"],
               "tile_s": stats["infer.tile_s"], "collate_s": stats["infer.collate_s"],
               "pack_s": stats["infer.pack_s"], "upload_s": stats["infer.upload_s"]}
    if not (forward["tile_launches"] > 0 and forward["gather_launches"] > 0
            and forward["tile_fetches"] <= 2):
        raise AssertionError(f"tiler: the forward ran {forward}")
    return {"card": card, "clouds": rows, "forward": forward,
            "phase_s": time.perf_counter() - t_phase}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    import numpy as np

    from smart_tree_tpu_torch.core import fused_conv, kernels, slab_conv
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
    batches = list(BlockTiler(cloud, 0.01, 4.0, 0.4).batches(
        4, max_capacity=mi16.max_batch_capacity))
    convs = bench_convs(mi16, batches)
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
        for name, rb, n, cin, cout in convs:
            if select(rb, cin, cout):
                key = (cin, cout)
                if key not in best or rb.shape[0] > best[key][1].shape[0]:
                    best[key] = (name, rb, n)
        return sorted(best.items())

    # the slab kernel at each (Cin, Cout) it takes, at its tallest rulebook
    slab_rows_out = []
    for (cin, cout), (name, rb, n) in tallest(lambda rb, ci, co: True):
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
            lambda rb, ci, co: fused_conv.should_use_fused(rb.shape[0], 27, ci, co)):
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
    del feats, rb, no_rb, w, fe, fe16, idx, out, got, ref, scratch
    # (b) the dispatch crossover, both kernels against route 3 by row count
    crossover = dispatch_crossover(torch, np, convs, mi16.max_batch_capacity, card)
    del convs

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
    from smart_tree_tpu_torch.neighbors import grid_count
    from smart_tree_tpu_torch.scripts.profile_pipeline import bench_pipeline, timed_run
    from smart_tree_tpu_torch.skeleton import path as tpath
    from smart_tree_tpu_torch.skeleton import skeletonize
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
    tracer_inputs = []
    forest = skeletonize.sample_forest

    def captured_forest(*a, **k):
        tracer_inputs[:] = [a[:5], k["hop_cap"], k["max_branches"]]
        return forest(*a, **k)

    with tempfile.TemporaryDirectory() as out_dir:
        pipeline = bench_pipeline(out_dir)
        timed_run(pipeline, raw_cloud)  # warm-up (raises hop_cap if the strict check asks)
        slab_conv.slab_gather_conv.launches = 0
        fused_conv.fused_gather_gemm.launches = 0
        grid_count.grid_radius_count.launches = 0
        tpath.greedy_steps.launches = 0
        torch.cuda.reset_peak_memory_stats()
        skeletonize.sample_forest = captured_forest
        try:
            pipe_stats, skeleton = timed_run(pipeline, raw_cloud)
        finally:
            skeletonize.sample_forest = forest
        pipe_slab_launches = slab_conv.slab_gather_conv.launches
        pipe_count_launches = grid_count.grid_radius_count.launches
        pipe_tracer_launches = tpath.greedy_steps.launches
        pipe_stats["peak_bytes"] = torch.cuda.max_memory_allocated()
        if pipe_slab_launches == 0:
            raise AssertionError("the bf16 pipeline never launched the slab kernel")
        if pipe_count_launches == 0:
            raise AssertionError("the pipeline's outlier filter never launched the count kernel")
        if pipe_tracer_launches == 0 or not tracer_inputs:
            raise AssertionError("the pipeline's skeletoniser never launched the tracer's kernels")
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
                      count_launches=pipe_count_launches, tracer_launches=pipe_tracer_launches,
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
    bench_medial = (branch16.medial_pts, branch16.radius)
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
    exact10 = exact_knn(torch, np, mp, k, r_max, seed=10)
    log(f"bench tree knn / grid_knn against float64: largest relative error "
        f"{exact10['knn']['max_rel_err']:.3g} / {exact10['grid_knn']['max_rel_err']:.3g}, "
        f"{exact10['seconds']:.2f} s ({card})")
    grid_stats = {
        "card": card, "vertices": int(mp.shape[0]), "k": k, "r": r_max, "exact": exact10,
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
        # phase 16 (e)'s data scripts, while phase 11's corpus exists
        scripts16 = corpus_scripts(work)

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

    # 16. the modules ported last
    remaining = remaining_phase(torch, np, mi16, batches, out16, skeleton, expected, on_cpu,
                                scripts16, card)

    # 17. the user tools
    tools, eval_launches, forest_launches, forest_medial = tools_phase(torch, np, card)

    # 18. the training probes; a failed check fails the script after its line
    probes, probe_launches, probe_problems = probes_phase(torch, np, card)

    # 19. the port's bench and the roofline of its forward, in a child process
    torch.cuda.empty_cache()
    bench = bench_phase(card)

    # 20. the batch sizing at the card's budget
    torch.cuda.empty_cache()
    sizing, slab_tall_rows = sizing_phase(torch, np, card)

    # 21. exact plans on the card
    torch.cuda.empty_cache()
    exact_plans = exact_plan_phase(torch, np, card, tools["forest_scan"])

    # 22. the outlier filter's count kernel on the bench tree's and the forest's inputs
    radius_counts, count_rows = radius_count_phase(
        torch, np, card, {"bench": bench_medial, "forest": forest_medial})
    del forest_medial

    # 23. the branch tracer's kernels on phase 8's tracer inputs
    tracer_row = tracer_phase(torch, card, *tracer_inputs)
    del tracer_inputs

    # 24. the forward's device tiler on the bench tree and the forest
    tiling = tiler_phase(torch, np, card)

    def summed(rows, key):
        return sum(r[key] for r in rows)

    def entry(rows, **head):
        """One kernel's line: one call at each shape the main path gives it,
        summed; per-shape rows under "shapes"."""
        return {
            **head,
            "max_abs_err": max(r["max_abs_err"]
                               for r in rows + head.get("card_capacity_shapes", [])),
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
              launches_per_z9_bf16_forward=remaining["z9"]["slab_launches_per_bf16_forward"]["z9"],
              launches_in_bf16_evaluations=eval_launches,
              launches_in_forest_scan=forest_launches,
              launches_in_probes=probe_launches["slab_gather_conv"],
              launches_per_bench_forward=bench["bench"]["slab_launches_per_forward"],
              forward_kernel_ms=slab_forward_ms,
              forward_fragment_ms=slab_fragment_ms,
              card_capacity_shapes=slab_tall_rows),
        entry(fused_rows_out,
              name="fused_gather_gemm", route="cuda",
              source="smart_tree_tpu_torch/csrc/fused_conv.cu",
              replaces="smart_tree_tpu/core/pallas_ops.py:86",
              launches=fused_launches, launches_per_forward=fused_per_forward,
              launches_per_culled_fused_forward=culled_launches["fused_launches"],
              launches_in_probes=probe_launches["fused_gather_gemm"],
              forward_kernel_ms=fused_forward_ms),
        {
            "name": "grid_radius_count", "route": "cuda",
            "source": "smart_tree_tpu_torch/csrc/radius_count.cu",
            "replaces": "smart_tree_tpu/neighbors/knn.py:256",
            "launches": pipe_count_launches,
            "launches_in_forest_scan": tools["forest_scan"]["count_launches"],
            "max_abs_err": max(r["max_abs_err"] for r in count_rows),
            **{k: summed(count_rows, k) for k in ("ms", "kernel_ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in count_rows)
            else "operations",
            "library_ms": None,
            "radius_count_ms": count_rows[0]["radius_count_ms"],
            "shapes": count_rows,
        },
        {
            "name": "tracer", "route": "cuda",
            "source": "smart_tree_tpu_torch/csrc/tracer.cu",
            "replaces": "smart_tree_tpu/skeleton/path.py:224",
            "launches": pipe_tracer_launches,
            "launches_in_sample_tree": remaining["skeleton"]["tracer_launches"],
            **{k: tracer_row[k] for k in ("max_abs_err", "ms", "kernel_ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")},
            "shapes": [tracer_row],
        },
        {
            "name": "tiler", "route": "cuda",
            "source": "smart_tree_tpu_torch/csrc/tiler.cu",
            "replaces": None,
            "launches": tiling["forward"]["tile_launches"] + tiling["forward"]["gather_launches"],
            "max_abs_err": 0,
            **{k: summed(tiling["clouds"], k) for k in ("ms", "kernel_ms", "plain_ms",
                                                        "bound_ms")},
            "host_ms": summed(tiling["clouds"], "host_ms"),
            "bound_by": "bytes", "library_ms": None,
            "shapes": tiling["clouds"],
        },
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
    print(json.dumps({"remaining_modules": remaining}), flush=True)
    print(json.dumps({"tools": tools}), flush=True)
    print(json.dumps({"probes": probes}), flush=True)
    print(json.dumps({"bench": bench}), flush=True)
    print(json.dumps({"sizing": sizing}), flush=True)
    print(json.dumps({"dispatch": crossover}), flush=True)
    print(json.dumps({"exact_plans": exact_plans}), flush=True)
    print(json.dumps({"radius_count": radius_counts}), flush=True)
    print(json.dumps({"tiler": tiling}), flush=True)
    if probe_problems:
        raise AssertionError("; ".join(probe_problems))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
