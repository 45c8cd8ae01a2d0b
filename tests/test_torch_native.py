"""The port's native host library (smart_tree_tpu_torch/native) against its
own numpy plain versions and against smart_tree_tpu.native, the port's
voxelize_host (which goes through it) against the JAX one, and the tiler's
one-pass halo binning (`tile_blocks`, the port's own entry) against its
per-block cube filter.

Every test here needs g++ to build st_native.cpp; without it they skip and
say so. The library's results are integer and boolean, so every comparison
is exact.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from smart_tree_tpu import native as jnative
from smart_tree_tpu.data import dataset as jds
from smart_tree_tpu_torch import native
from smart_tree_tpu_torch.data import dataset as tds
from smart_tree_tpu_torch.data.cloud import Cloud
from smart_tree_tpu_torch.utils.maths import cube_filter

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH: the native library cannot be built on this host")
    native.load()


def _cloud(seed, n, lo=-3.0, hi=3.0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    xyz[n // 2:] = xyz[: n - n // 2] + rng.normal(0, 1e-4, size=(n - n // 2, 3)).astype(np.float32)
    return xyz


@pytest.mark.parametrize("seed,n,voxel", [(0, 20000, 0.05), (1, 5000, 0.01), (2, 1, 0.1),
                                          (3, 30000, 0.2)])
def test_voxelize_matches_plain_and_jax(gxx, seed, n, voxel):
    xyz = _cloud(seed, n)
    origin = xyz.min(axis=0)
    coords, first = native.voxelize(xyz, voxel, origin)
    ref_coords, ref_first = native.voxelize_plain(xyz, voxel, origin)
    np.testing.assert_array_equal(coords, ref_coords)
    np.testing.assert_array_equal(first, ref_first)
    assert coords.dtype == np.int32 and first.dtype == np.int64
    jref = jnative.voxelize(xyz, voxel, origin)
    if jref is not None:   # the JAX loader falls back to None without a toolchain
        np.testing.assert_array_equal(coords, jref[0])
        np.testing.assert_array_equal(first, jref[1])


def test_voxelize_of_no_points(gxx):
    coords, first = native.voxelize(np.zeros((0, 3), np.float32), 0.01, np.zeros(3))
    assert coords.shape == (0, 3) and first.shape == (0,)


@pytest.mark.parametrize("size", [1.2, 4.0])
def test_cube_filter_matches_plain_and_jax(gxx, size):
    xyz = _cloud(4, 5000, -2.0, 2.0)
    centre = np.asarray([0.25, -0.5, 0.1], np.float32)
    got = native.cube_filter(xyz, centre, size)
    np.testing.assert_array_equal(got, cube_filter(xyz, centre, np.float32(size)))
    jref = jnative.cube_filter(xyz, centre, size)
    if jref is not None:
        np.testing.assert_array_equal(got, jref)


def test_block_ids_match_plain_and_jax(gxx):
    xyz = _cloud(5, 10000, -6.0, 6.0)
    ids, blocks = native.block_ids(xyz, 4.0)
    ref_ids, ref_blocks = native.block_ids_plain(xyz, 4.0)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(blocks, ref_blocks)
    np.testing.assert_array_equal(blocks[ids], np.floor(xyz / np.float32(4.0)).astype(np.int32))
    jref = jnative.block_ids(xyz, 4.0)
    if jref is not None:
        np.testing.assert_array_equal(ids, jref[0])
        np.testing.assert_array_equal(blocks, jref[1])


def _kept_ids(xyz, block_size, min_points=20):
    """The tiler's blocks: cells of block_size holding more than min_points
    points."""
    q = np.floor(xyz / np.float32(block_size)).astype(np.int64)
    ids, counts = np.unique(q, axis=0, return_counts=True)
    return ids[counts > min_points]


def _face_cloud(block, buffer, seed=8, n=6000):
    """Points whose coordinates lie on block faces, halo faces and interior
    faces of the cells -2..2, or one float32 step to either side of them."""
    ks = np.arange(-2, 3, dtype=np.float64)[:, None] * block
    faces = (ks + np.asarray([0.0, -buffer, buffer, block / 2, block + buffer])).ravel()
    faces = faces.astype(np.float32)
    faces = np.concatenate([faces, np.nextafter(faces, np.float32(np.inf)),
                            np.nextafter(faces, np.float32(-np.inf))])
    return np.random.default_rng(seed).choice(faces, size=(n, 3))


def _min_points_cloud(seed=9):
    """Cells of exactly 20 and of 21 points (at min_points 20 the first is
    dropped and the second kept) beside a dense one."""
    rng = np.random.default_rng(seed)
    parts = [rng.uniform(0.05, 0.95, (n, 3)) + np.asarray(c, np.float64)
             for n, c in ((20, (0, 0, 0)), (21, (1, 0, 0)), (400, (0, 1, 0)))]
    return np.concatenate(parts).astype(np.float32)


TILE_CASES = {
    "block4-buffer0.4": lambda: (_cloud(10, 20000, -9.0, 9.0), 4.0, 0.4),
    "block1-buffer0.1": lambda: (_cloud(11, 20000, -2.5, 3.5), 1.0, 0.1),
    "block0.5-buffer0.05": lambda: (_cloud(12, 20000, -1.2, 1.3), 0.5, 0.05),
    "block1-buffer0.6": lambda: (_cloud(13, 20000, -3.0, 3.0), 1.0, 0.6),
    "block1-buffer1.2": lambda: (_cloud(17, 20000, -3.0, 3.0), 1.0, 1.2),
    "negative-coordinates": lambda: (_cloud(14, 20000, -7.0, -0.5), 1.0, 0.1),
    "faces-block1": lambda: (_face_cloud(1.0, 0.1), 1.0, 0.1),
    "faces-block4": lambda: (_face_cloud(4.0, 0.4), 4.0, 0.4),
    "faces-block0.5": lambda: (_face_cloud(0.5, 0.05), 0.5, 0.05),
    "faces-block1-buffer0.6": lambda: (_face_cloud(1.0, 0.6), 1.0, 0.6),
    # halo faces a float32 point can sit on exactly
    "faces-block1-buffer0.25": lambda: (_face_cloud(1.0, 0.25), 1.0, 0.25),
    "min-points": lambda: (_min_points_cloud(), 1.0, 0.1),
    "no-blocks": lambda: (_cloud(15, 500, -1.0, 1.0), 1.0, 0.1),
}


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tile_blocks_matches_plain(gxx, case):
    xyz, block, buffer = TILE_CASES[case]()
    ids = _kept_ids(xyz, block) if case != "no-blocks" else np.zeros((0, 3), np.int64)
    offsets, rows, interior, tests = native.tile_blocks(xyz, ids, block, buffer)
    ref = native.tile_blocks_plain(xyz, ids, block, buffer)
    for got, want in zip((offsets, rows, interior), ref):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert len(offsets) == len(ids) + 1 and ref[3] == len(xyz) * len(ids)
    # a test a block whose buffered slab holds the point on every axis: a
    # point lies in at most ceil(1 + 2 buffer / block) slabs an axis
    assert tests <= int(np.ceil(1 + 2 * buffer / block)) ** 3 * len(xyz)
    assert tests >= len(rows)
    if case == "min-points":
        assert ids.tolist() == [[0, 1, 0], [1, 0, 0]]
    if case in ("block1-buffer0.6", "block1-buffer1.2"):
        # three or four blocks an axis: some point lies in more than 2 x 2 x 2
        # halos, or more than 3 x 3 x 3
        assert np.bincount(rows).max() > (8 if buffer < block else 27)
    if case.startswith("faces"):
        assert 0 < interior.sum() < len(interior)


def test_tile_blocks_checks_its_input(gxx):
    xyz = _cloud(16, 100)
    with pytest.raises(ValueError, match="repeat"):
        native.tile_blocks(xyz, [[0, 0, 0], [0, 0, 0]], 1.0, 0.1)
    with pytest.raises(ValueError, match=r"\[B, 3\]"):
        native.tile_blocks(xyz, [0, 0, 0], 1.0, 0.1)
    with pytest.raises(ValueError, match="positive"):
        native.tile_blocks(xyz, [[0, 0, 0]], 0.0, 0.1)


def test_entry_points_check_shapes(gxx):
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        native.voxelize(np.zeros((4, 2), np.float32), 0.1, np.zeros(3))
    with pytest.raises(ValueError, match="3 values"):
        native.cube_filter(np.zeros((4, 3), np.float32), np.zeros(2), 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_voxelize_host_equals_jax_and_plain(gxx, seed):
    xyz = _cloud(seed, 12000, -1.5, 2.5)
    data = np.random.default_rng(seed).normal(size=(len(xyz), 6)).astype(np.float32)
    got = tds.voxelize_host(xyz, data, 0.01)
    for ref in (tds.voxelize_host_plain(xyz, data, 0.01), jds.voxelize_host(xyz, data, 0.01)):
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # the survivors are np.unique's: lexicographic coords, lowest original row
    g = np.floor((xyz - got[2]) / 0.01).astype(np.int32)
    ref_coords, first = np.unique(g, axis=0, return_index=True)
    np.testing.assert_array_equal(got[0], ref_coords)
    np.testing.assert_array_equal(got[1], data[first])


def test_the_main_path_goes_through_the_library(gxx, monkeypatch):
    calls = []
    voxelize = native.voxelize
    monkeypatch.setattr(native, "voxelize", lambda *a: calls.append(len(a[0])) or voxelize(*a))
    xyz = _cloud(6, 8000, 0.0, 3.0)
    tiler = tds.BlockTiler(Cloud(xyz=xyz), 0.01, 2.0, 0.2)
    assert len(calls) == len(tiler.blocks) >= 2


def test_the_forward_tiles_through_the_library_and_counts_its_tests(gxx, monkeypatch):
    """The forward finds its kept blocks through the library
    (`native.block_ids`, once), and its device tiler (core/tiler.py) counts
    the point-box tests `native.tile_blocks` makes on those blocks."""
    from smart_tree_tpu_torch.infer.inference import ModelInference

    calls = []
    block_ids = native.block_ids
    monkeypatch.setattr(native, "block_ids", lambda *a: calls.append(len(a[0])) or block_ids(*a))
    xyz = _cloud(6, 8000, 0.0, 3.0)
    mi = ModelInference("smart_tree_tpu/weights/noble-elevator-58.npz", device="cpu",
                        block_size=2.0, buffer_size=0.2)
    stats = {}
    mi.forward(Cloud(xyz=xyz), stats=stats)
    assert calls == [len(xyz)]
    ids = tds.kept_blocks(xyz, 2.0)
    _, rows, _, tests = native.tile_blocks(xyz, ids, 2.0, 0.2)
    assert len(ids) > 2 and stats["tile_box_tests"] == tests
    assert len(rows) <= stats["tile_box_tests"] <= 27 * len(xyz)


def test_a_failed_build_raises_on_the_main_path(gxx, monkeypatch, tmp_path):
    bad = tmp_path / "st_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    xyz = _cloud(7, 100)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tds.voxelize_host(xyz, xyz, 0.01)
    assert not list((tmp_path / "build").glob("*.so"))   # no partial library left


def test_concurrent_builds_leave_one_loadable_library(gxx, tmp_path):
    """Several processes building into one empty folder at once (as test
    workers do) each end with a whole library, and one library is left."""
    code = (
        "import sys\nfrom pathlib import Path\nimport numpy as np\n"
        "from smart_tree_tpu_torch import native\n"
        "native._BUILD_DIR = Path(sys.argv[1])\n"
        "xyz = np.random.default_rng(0).uniform(0, 1, (1000, 3)).astype(np.float32)\n"
        "c, f = native.voxelize(xyz, 0.1, xyz.min(0))\n"
        "print(len(c))\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert len({out for out, _ in outs}) == 1 and int(outs[0][0]) > 500
    libs = sorted(tmp_path.iterdir())
    assert len(libs) == 1 and libs[0].suffix == ".so", libs
