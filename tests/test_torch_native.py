"""The port's native host library (smart_tree_tpu_torch/native) against its
own numpy plain versions and against smart_tree_tpu.native, and the port's
voxelize_host (which goes through it) against the JAX one.

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
