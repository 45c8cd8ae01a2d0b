"""Port parity for the inference slice as a whole: ModelInference.predict of
smart_tree_tpu_torch against smart_tree_tpu's ModelInference on the
full-download single-device path (`compact_transfers=False` on the JAX side;
the port's forward is held in test_torch_transfers.py), plus the host-side
pieces (synthetic trees, tiling, file input, memory model), the device rules
and import hygiene.

The JAX full-download path still quantises what it returns (fp16 radius,
int8 direction, argmax class: `compress_preds`); the comparison swaps that
one function for an identity so both sides are held at full precision, at
the model tolerance rtol 1e-3 / atol 1e-4 (fp32 summation order through the
UNet), on class logits rather than argmax.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import smart_tree_tpu.infer.inference as jinf
from smart_tree_tpu.core import memory as jmem
from smart_tree_tpu.data import dataset as jds
from smart_tree_tpu.data import file as jfile
from smart_tree_tpu.data.augmentations import CentreCloud as JCentre
from smart_tree_tpu.data.synthetic import generate_tree as jgenerate
from smart_tree_tpu_torch.core import memory as tmem
from smart_tree_tpu_torch.data import dataset as tds
from smart_tree_tpu_torch.data import file as tfile
from smart_tree_tpu_torch.data.augmentations import AugmentationPipeline, CentreCloud
from smart_tree_tpu_torch.data.cloud import Cloud
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.infer.inference import ModelInference
from smart_tree_tpu_torch.tools.bench_scan import make_forest
from smart_tree_tpu_torch.utils.maths import cube_filter

REPO = Path(__file__).resolve().parent.parent
WEIGHTS = "smart_tree_tpu/weights/noble-elevator-58.npz"
# small enough for ONE batch (one capacity-16384 forward)
TREE = dict(seed=3, height=2.0, trunk_radius=0.08, points_per_m2=3000.0,
            foliage_points=300)


@pytest.mark.parametrize(
    "kw",
    [TREE, dict(seed=0, height=12.0, trunk_radius=0.25, points_per_m2=500.0,
                foliage_points=2000)],
    ids=["small", "bench-shape"],
)
def test_generate_tree_bit_identical(kw):
    tc, tsk = generate_tree(**kw)
    jc, jsk = jgenerate(**kw)
    for f in ("xyz", "rgb", "medial_vector", "branch_direction", "branch_ids", "class_l"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f), err_msg=f)
    assert sorted(tsk.branches) == sorted(jsk.branches)
    for bid, b in tsk.branches.items():
        np.testing.assert_array_equal(b.xyz, jsk.branches[bid].xyz)
        np.testing.assert_array_equal(b.radii, jsk.branches[bid].radii)
        assert b.parent_id == jsk.branches[bid].parent_id
    np.testing.assert_array_equal(
        AugmentationPipeline([CentreCloud()])(tc).xyz, JCentre()(jc).xyz
    )


def _by_xyz(xyz):
    return {tuple(r): i for i, r in enumerate(np.asarray(xyz, np.float32).tolist())}


def test_forward_matches_jax_full_download(monkeypatch):
    cloud, _ = generate_tree(**TREE)
    cloud = CentreCloud()(cloud)
    jcloud = JCentre()(jgenerate(**TREE)[0])

    port = ModelInference(WEIGHTS, device="cpu", precision="float32")
    batches = list(tds.BlockTiler(cloud, 0.01, 4.0, 0.4).batches(
        4, max_capacity=port.max_batch_capacity))
    assert len(batches) == 1
    port_runs = []
    port_run_batch = port._run_batch
    monkeypatch.setattr(port, "_run_batch", lambda vb:
                        port_runs.append(len(vb.coords)) or port_run_batch(vb))
    got = port.predict(cloud)
    assert len(got["xyz"]) == int(batches[0].mask.sum())

    # JAX side: full-precision payload, single-device full-download path
    def identity_payload(preds):
        return {"radius": preds["radius"], "direction": preds["direction"],
                "class_l": preds["class_l"]}

    monkeypatch.setattr(jinf, "compress_preds", identity_payload)
    taken = []
    run_batch = jinf.ModelInference._run_batch
    monkeypatch.setattr(jinf.ModelInference, "_run_batch",
                        lambda self, vb, level_caps=None: taken.append(level_caps)
                        or run_batch(self, vb, level_caps))
    monkeypatch.setattr(jinf.ModelInference, "_submit_multichip",
                        lambda *a, **k: pytest.fail("took the multichip path"))
    jmi = jinf.ModelInference(WEIGHTS, precision="float32",
                              compact_transfers=False, medial_classes=None)
    assert jmi.max_batch_capacity == port.max_batch_capacity
    ref = jmi.forward(jcloud)
    # the single-device path: JAX reruns the overflowed batch at larger
    # level capacities, the port's exact plan runs it once
    assert taken[0] is None and len(taken) > 1
    assert port_runs == [len(batches[0].coords)] and len(port.plan_rows) == 1
    ref_logits = np.asarray(ref.class_l).reshape(-1, 2)

    # rows may come back in another order: match them by xyz
    assert len(ref.xyz) == len(got["xyz"])
    index = _by_xyz(ref.xyz)
    rows = np.asarray([index[tuple(r)] for r in got["xyz"].tolist()])
    np.testing.assert_array_equal(got["rgb"], np.asarray(ref.rgb)[rows])
    ref_mv = np.asarray(ref.medial_vector)[rows]
    ref_radius = np.log(np.linalg.norm(ref_mv, axis=1, keepdims=True))
    np.testing.assert_allclose(got["radius"], ref_radius, rtol=1e-3, atol=1e-4)
    # the medial vector on the host, as the full-download forward made it
    np.testing.assert_allclose(np.exp(got["radius"]) * got["direction"], ref_mv,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["class_logits"], ref_logits[rows], rtol=1e-3, atol=1e-4)


def test_tiler_and_batches_match_jax():
    cloud = CentreCloud()(generate_tree(**TREE)[0])
    jcloud = JCentre()(jgenerate(**TREE)[0])
    tt = tds.BlockTiler(cloud, 0.01, 4.0, 0.4)
    jt = jds.BlockTiler(jcloud, 0.01, 4.0, 0.4)
    assert tt.grid_shape == jt.grid_shape
    np.testing.assert_array_equal(tt.block_centres, jt.block_centres)
    for tb, jb in zip(tt.batches(2, max_capacity=4096), jt.batches(2, max_capacity=4096)):
        assert tb.spatial_shape == jb.spatial_shape and tb.batch_size == jb.batch_size
        np.testing.assert_array_equal(tb.origins, jb.origins)
        # the JAX package may dedup natively: compare voxel sets, not order
        for f in ("valid", "mask"):
            assert getattr(tb, f).sum() == getattr(jb, f).sum()
        tk = {tuple(r) for r in tb.coords[tb.valid].tolist()}
        jk = {tuple(r) for r in jb.coords[jb.valid].tolist()}
        assert tk == jk
        tc16, tres, torig = tb.compressed_xyz_upload()
        assert tc16.dtype == np.int16 and tres.dtype == np.float16
        np.testing.assert_array_equal(torig, jb.compressed_xyz_upload()[2])


class _PerBlockTiler(tds.BlockTiler):
    """The tiler as it was before the one-pass binning: one cube filter of
    the whole cloud a block for its halo, and one of its survivors for the
    interior. The plain reference of `BlockTiler`'s blocks."""

    def __init__(self, cloud, voxel_size, block_size=4.0, buffer_size=0.4, min_points=20):
        self.voxel_size, self.block_size, self.buffer_size = voxel_size, block_size, buffer_size
        side = int(np.ceil((block_size + 2 * buffer_size) / voxel_size)) + 1
        self.grid_shape = (side, side, side)
        xyz = np.asarray(cloud.xyz, np.float32)
        rgb = np.asarray(cloud.rgb, np.float32) if cloud.rgb is not None else np.zeros_like(xyz)
        q = np.floor(xyz / block_size).astype(np.int64)
        ids, counts = np.unique(q, axis=0, return_counts=True)
        self.block_centres = ids[counts > min_points] * block_size + block_size / 2
        self.blocks = []
        for centre in self.block_centres:
            m = cube_filter(xyz, centre, block_size + 2 * buffer_size)
            bxyz, brgb = xyz[m], rgb[m]
            coords, data, origin = self.dedup(
                bxyz, np.concatenate([bxyz, brgb], axis=1), voxel_size)
            interior = cube_filter(data[:, :3], centre, block_size)
            shape = tuple(int(v) + 1 for v in coords.max(axis=0))
            self.blocks.append(tds.Block(coords, data, interior, shape, origin))


def _small_forest():
    return make_forest(2, 150.0, seed=4)


def _no_rgb_tree():
    c = generate_tree(seed=5, height=3.0, trunk_radius=0.1, points_per_m2=2500.0,
                      foliage_points=500)[0]
    return Cloud(xyz=np.asarray(c.xyz, np.float32) - np.float32(1.3))


@pytest.mark.parametrize("make,grid", [
    (lambda: CentreCloud()(generate_tree(**TREE)[0]), (0.01, 4.0, 0.4)),
    (lambda: CentreCloud()(generate_tree(**TREE)[0]), (0.01, 1.0, 0.1)),
    (_small_forest, (0.01, 4.0, 0.4)),
    (_no_rgb_tree, (0.025, 0.5, 0.05)),
], ids=["tree", "tree-block1", "forest", "no-rgb"])
def test_tiler_equals_the_per_block_cube_filter_tiler(make, grid):
    cloud = make()
    new, ref = tds.BlockTiler(cloud, *grid), _PerBlockTiler(cloud, *grid)
    assert new.grid_shape == ref.grid_shape and len(new) == len(ref) >= 2
    np.testing.assert_array_equal(new.block_centres, ref.block_centres)
    for a, b in zip(new.blocks, ref.blocks):
        for f in ("coords", "feats", "interior", "origin"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert a.spatial_shape == b.spatial_shape
    cap = 1 << 16
    for x, y in zip(new.batches(4, max_capacity=cap), ref.batches(4, max_capacity=cap),
                    strict=True):
        for f in x._fields:
            u, v = getattr(x, f), getattr(y, f)
            if isinstance(u, np.ndarray):
                np.testing.assert_array_equal(u, v, err_msg=f)
            else:
                assert u == v, f
    # a point lies in at most 2 halos an axis (buffer under half a block), and
    # every halo row was one test
    halo_rows = sum(int(cube_filter(cloud.xyz, c, grid[1] + 2 * grid[2]).sum())
                    for c in ref.block_centres)
    assert halo_rows <= new.box_tests <= 8 * len(cloud)


def test_load_cloud_npz_and_ply(tmp_path):
    cloud, skeleton = jgenerate(**TREE)
    jfile.save_data_npz(tmp_path / "t.npz", skeleton, cloud)
    jfile.save_ply_cloud(tmp_path / "t.ply", cloud.xyz, cloud.rgb)
    for name in ("t.npz", "t.ply"):
        got, ref = tfile.load_cloud(tmp_path / name), jfile.load_cloud(tmp_path / name)
        for f in ("xyz", "rgb", "medial_vector", "class_l"):
            if getattr(ref, f) is None:
                assert getattr(got, f) is None
            else:
                np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
        assert got.filename == tmp_path / name
    np.testing.assert_array_equal(
        tfile.load_data_npz(tmp_path / "t.npz")[0].xyz,
        jfile.load_data_npz(tmp_path / "t.npz")[0].xyz,
    )


@pytest.mark.parametrize("factor", [0.5, 1.0])
def test_memory_model_matches_jax(factor):
    planes = (8, 16, 32, 64)
    for cap in (1024, 65536, 262144):
        assert tmem.estimate_forward_hbm(cap, planes, factor, in_flight=2) == \
            jmem.estimate_forward_hbm(cap, planes, factor, in_flight=2)
    assert tmem.max_capacity_for_budget(12 << 30, planes, factor, in_flight=2) == \
        jmem.max_capacity_for_budget(12 << 30, planes, factor, in_flight=2)


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card and no device="cpu", the entry points raise instead of
    carrying on on the CPU."""
    from smart_tree_tpu_torch import resolve_device
    from smart_tree_tpu_torch.core import fused_conv, slab_conv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelInference(WEIGHTS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    meta = torch.zeros((4, 8), device="meta")
    for fn in (slab_conv.slab_gather_conv, fused_conv.fused_gather_gemm):
        with pytest.raises(ValueError):
            fn(meta, torch.zeros((2, 27), dtype=torch.int32, device="meta"),
               torch.zeros((27, 8, 8), device="meta"))


def test_import_hygiene():
    """Importing the port and every submodule leaves jax and smart_tree_tpu
    out of sys.modules; chip_smoke.py names neither."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import smart_tree_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'smart_tree_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'smart_tree_tpu'))\n"
        "assert not bad, bad\n"
        "assert all('smart_tree_tpu_torch.parallel.' + m in sys.modules\n"
        "           for m in ('mesh', 'dp', 'block_infer'))\n"
        "print(len([m for m in sys.modules if m.startswith('smart_tree_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
    src = (REPO / "chip_smoke.py").read_text()
    import ast

    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "smart_tree_tpu"}, names
    assert "smart_tree_tpu_torch" in names
