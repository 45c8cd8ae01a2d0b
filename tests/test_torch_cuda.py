"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures JAX). Without a card every test
here skips. Tolerances: slab kernel atol 2e-4 (bf16 operands on both sides,
fp32 summation order only); fused kernel rtol 1e-4 / atol 1e-5 (fp32);
radius count kernel and the tracer's kernels equal bits (the plain
versions' arithmetic, op by op).
"""

import numpy as np
import pytest
import torch

from smart_tree_tpu_torch.core import fused_conv, slab_conv
from smart_tree_tpu_torch.core.plan import build_plan
from smart_tree_tpu_torch.core.sparse_tensor import SparseVoxelTensor
from smart_tree_tpu_torch.neighbors import grid_count
from tracer_trees import grown_tree

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _monotone(rng, m, n, density=0.8):
    rb = np.full((m, 27), -1, np.int32)
    for g in range(9):
        base = np.sort(rng.choice(n - 2, size=m, replace=n - 2 < m)) + 1
        for dz in range(3):
            mask = rng.random(m) < density
            rb[mask, 3 * g + dz] = (base + dz - 1)[mask]
    return rb


def _spread(rng, m, n):
    """Every column spans the whole table: many slab chunks per tile."""
    rb = np.full((m, 27), -1, np.int32)
    for k in range(27):
        col = np.sort(rng.choice(n, size=m, replace=False))
        mask = rng.random(m) < 0.9
        rb[mask, k] = col[mask]
    return rb


def _plan_rulebook(kind):
    rng = np.random.default_rng(4)
    coords = np.unique(
        np.concatenate([np.zeros((6000, 1)), rng.integers(0, 64, size=(6000, 3))],
                       axis=1).astype(np.int32), axis=0)
    cap = 8192
    coords = np.concatenate([coords, np.full((cap - len(coords), 4), -1, np.int32)])
    x = SparseVoxelTensor.from_coords(torch.from_numpy(coords), torch.zeros(cap, 3),
                                      (64,) * 3, 1,
                                      valid=torch.from_numpy(coords[:, 0] >= 0))
    lv0, lv1 = build_plan(x, 2).levels
    return {"subm": lv0.subm_rb, "down": lv0.down_rb, "up": lv0.up_rb}[kind].numpy()


def _with_table(rb):
    return rb, int(rb.max()) + 1


def _edges(rng):
    """M not a multiple of the tile, a group that is empty in every tile, an
    all-missing tile in the middle, and an entry equal to N - 1."""
    n, m = 700, 3 * slab_conv.TILE_ROWS + 37
    rb = _monotone(rng, m, n)
    rb[:, 6:9] = -1
    rb[slab_conv.TILE_ROWS : 2 * slab_conv.TILE_ROWS] = -1
    rb[-1, 26] = n - 1
    return rb, n


SLAB_RULEBOOKS = {
    # name: rng -> (rulebook, table rows)
    "monotone": lambda r: (_monotone(r, 1000, 1200), 1200),
    "multi-chunk": lambda r: (_spread(r, 512, 4 * 1024 + 37), 4 * 1024 + 37),
    "ragged-empty": lambda r: (np.concatenate([_monotone(r, 300, 600),
                                               np.full((423, 27), -1, np.int32)]), 600),
    "edges": _edges,
    "plan-subm": lambda r: _with_table(_plan_rulebook("subm")),
    "plan-down": lambda r: _with_table(_plan_rulebook("down")),
    "plan-up": lambda r: _with_table(_plan_rulebook("up")),
}


def _slab_operands(cuda, name, cin, cout):
    rng = np.random.default_rng(0)
    rb, n = SLAB_RULEBOOKS[name](rng)
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(
        (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    ).to(cuda)
    return feats, torch.from_numpy(rb).to(cuda), w


@pytest.mark.parametrize("cout", [8, 16, 32, 64])
@pytest.mark.parametrize("cin", [8, 16, 32, 64])
@pytest.mark.parametrize("name", sorted(SLAB_RULEBOOKS))
def test_slab_kernel_matches_plain(cuda, name, cin, cout):
    feats, rb, w = _slab_operands(cuda, name, cin, cout)
    launches = slab_conv.slab_gather_conv.launches
    got = slab_conv.slab_gather_conv(feats, rb, w)
    torch.cuda.synchronize()
    assert slab_conv.slab_gather_conv.launches == launches + 1
    ref = slab_conv.slab_gather_conv_plain(feats, rb, w)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=2e-4)
    empty = (rb < 0).all(dim=1)
    assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("cin,cout", [(24, 16), (40, 8), (56, 64)])
def test_slab_kernel_odd_slice_counts(cuda, cin, cout):
    # Cin / 8 odd: the group's last k16 step is padded with a zero slice
    feats, rb, w = _slab_operands(cuda, "edges", cin, cout)
    got = slab_conv.slab_gather_conv(feats, rb, w)
    ref = slab_conv.slab_gather_conv_plain(feats, rb, w)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=2e-4)


def test_slab_kernel_matches_tiled_emulation(cuda):
    feats, rb, w = _slab_operands(cuda, "multi-chunk", 16, 16)
    got = slab_conv.slab_gather_conv(feats, rb, w).cpu()
    emu = slab_conv.slab_gather_conv_tiled(feats.cpu(), rb.cpu(), w.cpu(),
                                           slab=slab_conv.slab_rows(16))
    np.testing.assert_allclose(got.numpy(), emu.numpy(), atol=2e-4)


def test_kernels_are_deterministic(cuda):
    feats, rb, w = _slab_operands(cuda, "plan-subm", 32, 32)
    assert torch.equal(slab_conv.slab_gather_conv(feats, rb, w),
                       slab_conv.slab_gather_conv(feats, rb, w))
    assert torch.equal(fused_conv.fused_gather_gemm(feats, rb, w),
                       fused_conv.fused_gather_gemm(feats, rb, w))


def _fused_operands(cuda, n, m, k3, cin, cout, missing_rows=()):
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32)).to(cuda)
    rb = rng.integers(-1, n, size=(m, k3)).astype(np.int32)
    for r in missing_rows:
        rb[r] = -1
    w = torch.from_numpy(
        (rng.normal(size=(k3, cin, cout)) / np.sqrt(k3 * cin)).astype(np.float32)
    ).to(cuda)
    return feats, torch.from_numpy(rb).to(cuda), w


FUSED_SHAPES = [
    # (n, m, k3, cin, cout)
    (300, 200, 27, 8, 16),
    (513, 700, 27, 32, 8),
    (64, 100, 8, 16, 32),
    (40, 50, 1, 4, 8),
    (5000, 3000, 27, 64, 64),
    (3000, 2000, 27, 128, 64),
    (3000, 1000, 8, 128, 32),
    (900, 333, 1, 64, 16),
    (700, 129, 8, 4, 64),
    (2000, 1500, 27, 4, 32),
    (50, 17, 27, 8, 8),
]


@pytest.mark.parametrize("n,m,k3,cin,cout", FUSED_SHAPES)
def test_fused_kernel_matches_plain(cuda, n, m, k3, cin, cout):
    feats, rb, w = _fused_operands(cuda, n, m, k3, cin, cout)
    launches = fused_conv.fused_gather_gemm.launches
    got = fused_conv.fused_gather_gemm(feats, rb, w)
    torch.cuda.synchronize()
    assert fused_conv.fused_gather_gemm.launches == launches + 1
    ref = fused_conv.fused_gather_gemm_plain(feats, rb, w)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("k3,cin,cout", [(1, 4, 8), (8, 8, 16), (27, 64, 32), (27, 128, 64)])
def test_fused_kernel_all_missing_rows(cuda, k3, cin, cout):
    # whole tiles, single rows and the ragged last tile without a neighbour
    m = 3 * 128 + 19
    missing = list(range(128, 256)) + [0, 300, m - 1]
    feats, rb, w = _fused_operands(cuda, 500, m, k3, cin, cout, missing_rows=missing)
    got = fused_conv.fused_gather_gemm(feats, rb, w)
    ref = fused_conv.fused_gather_gemm_plain(feats, rb, w)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)
    assert bool((got[missing] == 0).all())


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    feats = torch.zeros((10, 12), device=cuda)  # Cin 12: not a multiple of 8
    rb = torch.zeros((4, 27), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        slab_conv.slab_gather_conv(feats, rb, torch.zeros((27, 12, 8), device=cuda))
    with pytest.raises(ValueError):
        fused_conv.fused_gather_gemm(feats[:, :8], rb, torch.zeros((27, 8, 8), device=cuda))
    with pytest.raises(ValueError):  # Cout 12
        fused_conv.fused_gather_gemm(feats[:, :8].contiguous(), rb,
                                     torch.zeros((27, 8, 12), device=cuda))
    f8 = feats[:, :8].contiguous()
    with pytest.raises(ValueError):  # Cin 72 is past the slab kernel's 64
        slab_conv.slab_gather_conv(torch.zeros((10, 72), device=cuda), rb,
                                   torch.zeros((27, 72, 8), device=cuda))
    with pytest.raises(ValueError):  # 26 columns
        slab_conv.slab_gather_conv(f8, rb[:, :26].contiguous(),
                                   torch.zeros((27, 8, 8), device=cuda))
    with pytest.raises(ValueError):  # int64 rulebook
        slab_conv.slab_gather_conv(f8, rb.long(), torch.zeros((27, 8, 8), device=cuda))
    with pytest.raises(ValueError):  # weights on the CPU
        fused_conv.fused_gather_gemm(f8, rb, torch.zeros((27, 8, 8)))
    with pytest.raises(ValueError):  # Cin 132 is past the fused kernel's 128
        fused_conv.fused_gather_gemm(torch.zeros((10, 132), device=cuda), rb,
                                     torch.zeros((27, 132, 8), device=cuda))


@pytest.mark.parametrize("cap,cell_scale", [(8, None), (1 << 20, None), (8, 1 / 8)],
                         ids=["cap8", "unsaturated", "small-cells"])
def test_radius_count_kernel_matches_plain(cuda, cap, cell_scale, monkeypatch):
    """The kernel against its plain version on the card, equal int32 bits:
    clustered points 30 m from the origin with duplicates, a mask, and
    infinite, huge and NaN radii among the rest; then through the filter,
    the card's keep mask against the CPU's."""
    from smart_tree_tpu_torch.skeleton.filter import outlier_removal

    rng = np.random.default_rng(21)
    centres = rng.uniform(-5, 5, size=(40, 3))
    p = centres[rng.integers(0, 40, 20000)] + rng.normal(scale=0.1, size=(20000, 3))
    p[10000:12000] = p[:2000]
    p = (p + np.array([30.0, 0.0, 10.0])).astype(np.float32)
    radii = rng.uniform(0.02, 0.2, len(p)).astype(np.float32)
    radii[[5, 6]] = np.inf
    radii[7] = 3e19
    radii[8] = np.nan
    valid = rng.uniform(size=len(p)) > 0.1
    valid[5:9] = True
    args = [torch.from_numpy(a).to(cuda) for a in (p, p, radii, valid, valid)]
    if cell_scale is not None:
        edge = float(np.median(radii[:100])) * cell_scale
        monkeypatch.setattr(grid_count, "_edge", lambda reach, counted, extent: edge)
    grid_count.grid_radius_count.launches = 0
    got = grid_count.grid_radius_count(*args, cap=cap)
    again = grid_count.grid_radius_count(*args, cap=cap)
    ref = grid_count.grid_radius_count_plain(*args, cap=cap)
    torch.cuda.synchronize()
    assert grid_count.grid_radius_count.launches == 2
    for a, b, c in zip(got, again, ref):
        assert a.dtype == torch.int32 and torch.equal(a, b) and torch.equal(a, c)
    assert int(got[0][5]) == min(int(valid.sum()), cap) and int(got[1][8]) == 0
    keep = outlier_removal(args[0], args[2], 8, args[3], 0.02)
    keep_cpu = outlier_removal(torch.from_numpy(p), torch.from_numpy(radii), 8,
                               torch.from_numpy(valid), 0.02)
    assert torch.equal(keep.cpu(), keep_cpu)


_TRACER_INPUTS = {}


def _tracer_inputs(kind, device):
    """Inputs of the branch tracer, as numpy: "tree", those the
    Skeletonizer gives it on a synthetic tree (1,491 vertices); "trunk",
    a straight 1,100-vertex trunk with 600 vertices grown off it, so that
    a path passes 1,024 hops and many windows."""
    if kind in _TRACER_INPUTS:
        return _TRACER_INPUTS[kind]
    if kind == "tree":
        from smart_tree_tpu_torch.data.cloud import Cloud
        from smart_tree_tpu_torch.data.synthetic import generate_tree
        from smart_tree_tpu_torch.skeleton import skeletonize

        seen = []

        def capture(*a, **k):
            seen.append([x.cpu().numpy() for x in a[:5]])
            return sample_forest(*a, **k)

        sample_forest = skeletonize.sample_forest
        c, _ = generate_tree(seed=3, height=5.0, trunk_radius=0.1, points_per_m2=2000.0)
        skeletonize.sample_forest = capture
        try:
            skeletonize.Skeletonizer(device=device).forward(
                Cloud(xyz=c.xyz, medial_vector=c.medial_vector))
        finally:
            skeletonize.sample_forest = sample_forest
        out = seen[0]
    else:
        out = list(grown_tree(8, 1700, 1100))
    _TRACER_INPUTS[kind] = out
    return out


def _plain_steps(tr, steps):
    from smart_tree_tpu_torch.skeleton import path as tpath

    for _ in range(steps):
        tpath.greedy_step_plain(tr)


@pytest.mark.parametrize("kind,hop_cap,max_branches", [
    ("tree", 4096, 4096), ("tree", 4096, 3), ("tree", 6, 4096),
    ("trunk", 4096, 4096), ("trunk", 1050, 4096),
], ids=["all-branches", "branch-cap", "hop-cap", "long-path", "hop-cap-past-a-chunk"])
def test_tracer_kernels_match_the_plain_step(cuda, kind, hop_cap, max_branches):
    """The tracer's kernels against greedy_step_plain, both on the card:
    the same state and header bit for bit, round by round; then the whole
    sample_tree_device on the card against the CPU."""
    from smart_tree_tpu_torch.skeleton import path as tpath

    inputs = _tracer_inputs(kind, cuda)
    got = {}
    for route, steps in (("kernel", tpath.greedy_steps), ("plain", _plain_steps)):
        tr = tpath._tracer_state(*[torch.from_numpy(a).to(cuda) for a in inputs], hop_cap,
                                 max_branches)
        launches = tpath.greedy_steps.launches
        stats = {}
        hdr, parents = tpath._rounds(tr, steps, stats)
        moved = tpath.greedy_steps.launches - launches
        assert moved == (3 * tpath.ROUND * stats["tracer_fetches"] if route == "kernel" else 0)
        got[route] = tr, hdr, parents
    (a, ha, pa), (b, hb, pb) = got["kernel"], got["plain"]
    assert ha == hb and pa == pb
    for name in ("dist", "allocated", "branch_ids", "path_branch", "path_pos", "parents",
                 "header"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    if max_branches == 3:
        assert ha[tpath.COUNT] == 3 and ha[tpath.CAP_HIT]
    else:
        assert ha[tpath.NO_WORK] and not ha[tpath.CAP_HIT]
    assert (ha[tpath.HOPS] > 0) == (hop_cap < 4096)
    if kind == "trunk":  # a path past a chunk of the trace, in many windows; many rounds
        assert int(a.path_pos.max()) >= 1024 and ha[tpath.ITERS] > tpath.ROUND

    card = tpath.sample_tree_device(*[torch.from_numpy(x).to(cuda) for x in inputs], hop_cap,
                                    max_branches)
    cpu = tpath.sample_tree_device(*[torch.from_numpy(x) for x in inputs], hop_cap,
                                   max_branches)
    for name in ("path_branch", "path_pos", "branch_ids"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), name
    np.testing.assert_array_equal(card.branch_parents, cpu.branch_parents)
    assert card[4:] == cpu[4:]


def test_fit_smoke_on_the_card_matches_the_cpu(cuda):
    """A few train steps on one small tree: the card against the CPU from one
    seed. The first step at rtol 1e-4 (fp32 summation order); later steps at
    rtol 1e-2 (Adam's early steps amplify last-bit gradient differences)."""
    from smart_tree_tpu_torch.data.synthetic import generate_tree
    from smart_tree_tpu_torch.train.train import fit_smoke

    cloud, _ = generate_tree(seed=3, height=2.0, trunk_radius=0.06, points_per_m2=6000.0,
                             foliage_points=300)
    before = slab_conv.slab_gather_conv.launches, fused_conv.fused_gather_gemm.launches
    on_card = fit_smoke(cloud, steps=6, capacity=16384, device=cuda)
    on_cpu = fit_smoke(cloud, steps=6, capacity=16384, device="cpu")
    assert np.isfinite(on_card).all() and on_card[-1] < on_card[0]
    np.testing.assert_allclose(on_card[0], on_cpu[0], rtol=1e-4)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-2)
    # training needs gradients: no forward-only hand kernel may have run
    assert before == (slab_conv.slab_gather_conv.launches,
                      fused_conv.fused_gather_gemm.launches)


@pytest.mark.parametrize("medial", [None, [0]], ids=["compact", "culled"])
def test_compact_transfers_on_the_card_match_the_cpu(cuda, medial):
    """The forward on the card without and with the download cull (pinned
    uploads, downloads on the copy stream, two batches in flight) against
    the CPU, on a tree cut into several batches. fp32 heads differ between
    the two within the model tolerance, so a quantised row may move by one fp16 ulp of its log radius
    (under 0.4 % of the radius) or one 1/127 step of a direction component:
    on rows whose class agrees every component of the medial vector lies
    within (2/127 + 0.4 %) of that row's length; classes agree on 99 % of
    the rows or more."""
    from smart_tree_tpu_torch.data.augmentations import CentreCloud
    from smart_tree_tpu_torch.data.synthetic import generate_tree
    from smart_tree_tpu_torch.infer.inference import ModelInference

    cloud = CentreCloud()(generate_tree(seed=3, height=2.0, trunk_radius=0.08,
                                        points_per_m2=3000.0, foliage_points=300)[0])
    kw = dict(block_size=1.0, buffer_size=0.1, batch_size=1, medial_classes=medial)
    weights = "smart_tree_tpu/weights/synthetic-r3.npz"
    card = ModelInference(weights, **kw)
    got = card.forward(cloud)
    card.max_in_flight = 1
    again = card.forward(cloud)
    ref = ModelInference(weights, device="cpu", **kw).forward(cloud)
    for f in ("xyz", "medial_vector", "class_l"):
        np.testing.assert_array_equal(getattr(got, f), getattr(again, f), err_msg=f)
    np.testing.assert_array_equal(got.xyz, ref.xyz)
    same = got.class_l[:, 0] == ref.class_l[:, 0]
    assert same.mean() >= 0.99
    a, b = got.medial_vector[same], ref.medial_vector[same]
    bound = (2.0 / 127 + 4e-3) * np.linalg.norm(b, axis=1, keepdims=True)
    assert (np.abs(a - b) <= bound).all()
    if medial:
        assert (got.medial_vector[got.class_l[:, 0] != 0] == 0).all()


@pytest.mark.parametrize("medial", [None, [0]], ids=["compact", "culled"])
def test_two_replicas_on_one_card_match_one(cuda, medial):
    """ModelInference(devices=["cuda:0", "cuda:0"]) deals the batches to two
    replicas on the card; its rows are the one-device forward's, equal bit
    for bit (same kernels on the same inputs), in the JAX multichip order."""
    from smart_tree_tpu_torch.data.augmentations import CentreCloud
    from smart_tree_tpu_torch.data.synthetic import generate_tree
    from smart_tree_tpu_torch.infer.inference import ModelInference

    cloud = CentreCloud()(generate_tree(seed=3, height=2.0, trunk_radius=0.08,
                                        points_per_m2=3000.0, foliage_points=300)[0])
    kw = dict(block_size=1.0, buffer_size=0.1, batch_size=1, medial_classes=medial,
              precision="bfloat16")
    weights = "smart_tree_tpu/weights/synthetic-r3.npz"
    one = ModelInference(weights, devices=["cuda:0"], **kw).forward(cloud)
    two_mi = ModelInference(weights, devices=["cuda:0", "cuda:0"], **kw)
    two = two_mi.forward(cloud)
    assert len(two_mi._sharded.models) == 2

    def rows(c):
        r = np.concatenate([c.xyz, c.rgb, c.medial_vector, c.class_l], axis=1)
        return r[np.lexsort(r.T)]

    assert len(one) > 1000
    np.testing.assert_array_equal(rows(two), rows(one))


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_z9_conv_on_the_card_matches_the_cpu_and_takes_no_kernel(cuda, precision):
    """The z-window subm conv on the card equals the full rulebook's route 3
    there (bit for bit: the window rows are the full rulebook) and the CPU's
    (fp32 summation order); the slab kernel is never launched for it."""
    from smart_tree_tpu_torch.core import sparse_ops
    from smart_tree_tpu_torch.core.rulebook import subm_rulebook, subm_rulebook9
    from smart_tree_tpu_torch.core.sparse_ops import ConvConfig, gather_conv

    rng = np.random.default_rng(9)
    coords = np.unique(np.concatenate([np.zeros((20000, 1)),
                                       rng.integers(0, 96, size=(20000, 3))],
                                      axis=1).astype(np.int32), axis=0)
    cap = 1 << 15
    coords = np.concatenate([coords, np.full((cap - len(coords), 4), -1, np.int32)])
    feats = torch.from_numpy(rng.normal(size=(cap, 16)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(27, 16, 32)) / np.sqrt(27 * 16)).astype(np.float32))
    cfg = ConvConfig(precision)
    out = {}
    for dev in ("cpu", cuda):
        x = SparseVoxelTensor.from_coords(torch.from_numpy(coords).to(dev), feats.to(dev),
                                          (96,) * 3, 1,
                                          valid=torch.from_numpy(coords[:, 0] >= 0).to(dev))
        rb9 = subm_rulebook9(x.keys, x.spatial_shape, 1)
        slab_conv.slab_gather_conv.launches = 0
        got = gather_conv(x.feats, rb9, w.to(dev), cfg)
        assert slab_conv.slab_gather_conv.launches == 0
        full = sparse_ops._gather_gemm(x.feats, subm_rulebook(x.keys, x.spatial_shape, 1, 3),
                                       w.to(dev), cfg, False)
        assert torch.equal(got, full)
        out[str(dev)] = got.cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-5, atol=1e-5)


def test_spans_leave_no_event_on_the_card(cuda):
    """A profiled forward on the card with CPU and CUDA activity: the
    program's spans (utils/trace.py) are host events only, so no CUDA-side
    event carries a span's name, and the benchmark's kernel busy time
    (benchmark/stbench/window.py) is the union of the kernels alone."""
    import importlib.util
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from smart_tree_tpu_torch.data.augmentations import CentreCloud
    from smart_tree_tpu_torch.data.synthetic import generate_tree
    from smart_tree_tpu_torch.infer.inference import ModelInference

    path = Path(__file__).resolve().parents[1] / "benchmark" / "stbench" / "window.py"
    spec = importlib.util.spec_from_file_location("bench_window", path)
    window = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(window)

    cloud = CentreCloud()(generate_tree(seed=3, height=2.0, trunk_radius=0.08,
                                        points_per_m2=3000.0, foliage_points=300)[0])
    mi = ModelInference("smart_tree_tpu/weights/noble-elevator-58.npz", block_size=1.0,
                        buffer_size=0.1, batch_size=1, medial_classes=[0],
                        precision="bfloat16")
    mi.forward(cloud)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mi.forward(cloud)
        torch.cuda.synchronize()
    events = prof.events()
    names = {"infer.forward", "infer.tile", "infer.collate", "infer.pack", "infer.upload",
             "infer.plan", "infer.unet", "infer.collect"}
    host = {e.name for e in events if str(e.device_type).endswith("CPU")}
    card = [e for e in events if str(e.device_type).endswith("CUDA")]
    assert names <= host
    assert not [e.name for e in card if e.name in names]
    kernels = [(e.time_range.start / 1e6, e.time_range.end / 1e6) for e in card
               if not e.name.startswith(("Memcpy", "Memset"))]
    assert kernels
    assert window.kernel_busy_s(events) == window.union_s(kernels)


def _tiler_cloud(name):
    from smart_tree_tpu_torch.data.augmentations import CentreCloud
    from smart_tree_tpu_torch.data.synthetic import generate_tree
    from smart_tree_tpu_torch.tools.bench_scan import make_forest

    if name == "bench":     # chip_smoke.py's bench tree
        return CentreCloud()(generate_tree(seed=0, height=12.0, trunk_radius=0.25,
                                           points_per_m2=12000.0, foliage_points=20000)[0])
    return make_forest(6, 8000.0, 0)   # the benchmark's forest


@pytest.mark.parametrize("name", ["bench", "forest"])
def test_tiler_kernels_match_the_plain_version(cuda, name):
    """csrc/tiler.cu against core/tiler.py's plain version on the bench tree
    and the forest (block 4 m, buffer 0.4 m, voxel 1 cm): the tiling's
    arrays and every batch's gather, int8 and fp16 residuals, equal bits."""
    from smart_tree_tpu_torch.core import tiler

    cloud = _tiler_cloud(name)
    before = tiler.tile_cloud.launches, tiler.gather.launches
    stats = {}
    got = tiler.tile_cloud(cloud, 0.01, 4.0, 0.4, cuda, stats=stats)
    ref = tiler.tile_cloud(cloud, 0.01, 4.0, 0.4, torch.device("cpu"))
    assert tiler.tile_cloud.launches == before[0] + 7 and stats["tile_fetches"] == 2
    for field in ("origins", "key", "first", "interior", "vstart"):
        assert torch.equal(getattr(got, field).cpu(), getattr(ref, field)), field
    np.testing.assert_array_equal(got.counts, ref.counts)
    np.testing.assert_array_equal(got.interior_counts, ref.interior_counts)
    assert got.box_tests == ref.box_tests > 0 and len(got.key) > 100000
    batches, ref_batches = got.batches(4, 262144), ref.batches(4, 262144)
    assert [b.blocks.tolist() for b in batches] == [b.blocks.tolist() for b in ref_batches]
    for b, rb in zip(batches, ref_batches):
        for int8 in (True, False):
            a = tiler.gather(b, torch.from_numpy(b.table()).to(cuda), int8)
            c = tiler.gather(rb, torch.from_numpy(rb.table()), int8)
            for x, y in zip(a, c):
                assert x.device.type == "cuda" and torch.equal(x.cpu(), y)
    assert tiler.gather.launches == before[1] + 2 * len(batches)


def test_the_forward_tiles_on_the_card(cuda, monkeypatch):
    """The forward's tiling on a card launches the kernels and never the
    plain version."""
    from smart_tree_tpu_torch.core import tiler
    from smart_tree_tpu_torch.data.augmentations import CentreCloud
    from smart_tree_tpu_torch.data.synthetic import generate_tree
    from smart_tree_tpu_torch.infer.inference import ModelInference

    cloud = CentreCloud()(generate_tree(seed=3, height=2.0, trunk_radius=0.08,
                                        points_per_m2=3000.0, foliage_points=300)[0])
    monkeypatch.setattr(tiler, "_PlainSteps", None)
    monkeypatch.setattr(tiler, "_gather_plain", None)
    mi = ModelInference("smart_tree_tpu/weights/noble-elevator-58.npz", block_size=1.0,
                        buffer_size=0.1, batch_size=1, medial_classes=[0])
    tiler.tile_cloud.launches = tiler.gather.launches = 0
    stats = {}
    assert len(mi.forward(cloud, stats=stats)) > 1000
    assert tiler.tile_cloud.launches == 7 and tiler.gather.launches > 1
    assert stats["tile_fetches"] == 2
