"""Block-parallel inference of the port (smart_tree_tpu_torch/parallel/,
`ModelInference(devices=...)`) against the JAX package's multichip path
(smart_tree_tpu/parallel/block_infer.py, `ModelInference._submit_multichip`),
which the conftest's 8 CPU devices make JAX take.

The tree tiles into 9 batches of two capacities, so both packages group the
batches by shape and deal a short group with repeated slots. The JAX
comparisons run at level_capacity_factor 1.0, where no level overflows: each
overflow rerun would compile another JAX program (a minute a mode instead of
16 s); the port's reruns on the replicas are held by the single-device test
at the default factor. Tolerances are
tests/test_torch_transfers.py's:
  - rows equal in order: xyz and rgb bit for bit;
  - full download (JAX's payload quantisation swapped for an identity, as in
    tests/test_torch_inference.py): log radius, medial vector and class
    logits rtol 1e-3 / atol 1e-4;
  - compact and culled downloads: classes equal on all but 1 % of the rows
    (rows near a class tie), medial vectors bit-equal on all but 1 % of the
    rows whose class agrees (rows whose quantised payload differs by one
    fp16 ulp of the log radius or one 1/127 step of a direction component),
    and on every such row each component within (2/127 + 4e-3) of the
    vector's length; culled rows of another class exactly 0.
Against the port's single-device forward the multi-device forward is equal
bit for bit, the rows in the JAX multichip order.
"""

import numpy as np
import pytest
import torch

import smart_tree_tpu.infer.inference as jinf
from smart_tree_tpu.data import dataset as jds
from smart_tree_tpu.data.augmentations import CentreCloud as JCentre
from smart_tree_tpu.data.synthetic import generate_tree as jgenerate
from smart_tree_tpu.parallel import block_infer as jblock
from smart_tree_tpu_torch.core import fused_conv
from smart_tree_tpu_torch.data import dataset as tds
from smart_tree_tpu_torch.data.augmentations import CentreCloud
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.infer.inference import ModelInference
from smart_tree_tpu_torch.parallel import (ShardedForward, make_devices, stack_device_batches,
                                           stack_device_batches_compact, world)

TREE = dict(seed=3, height=2.0, trunk_radius=0.08, points_per_m2=3000.0, foliage_points=300)
TILING = dict(block_size=1.0, buffer_size=0.1, batch_size=1)
WEIGHTS = "smart_tree_tpu/weights/synthetic-r3.npz"   # 'local' features, both classes on TREE
FEW = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clouds():
    return CentreCloud()(generate_tree(**TREE)[0]), JCentre()(jgenerate(**TREE)[0])


@pytest.fixture(scope="module")
def batches(clouds):
    cloud, jcloud = clouds
    tb = list(tds.BlockTiler(cloud, 0.01, 1.0, 0.1).batches(1, max_capacity=262144))
    jb = list(jds.BlockTiler(jcloud, 0.01, 1.0, 0.1).batches(1, max_capacity=262144))
    caps = sorted({len(b.coords) for b in tb})
    assert len(tb) == len(jb) == 9 and len(caps) == 2, caps
    return tb, jb


@pytest.mark.parametrize("n_dev", [4, 8])
def test_stacks_equal_jax(batches, n_dev):
    tb, jb = batches
    cap = len(tb[0].coords)
    tb = [b for b in tb if len(b.coords) == cap]   # one shape, as the callers group
    jb = [b for b in jb if len(b.coords) == cap]
    got, ref = stack_device_batches(tb, n_dev), jblock.stack_device_batches(jb, n_dev)
    assert len(got) == len(ref) >= 2 if n_dev == 4 else len(got) == len(ref) == 1
    for g, r in zip(got, ref):
        assert [b.feats.tobytes() for b in g[0]] == [b.feats.tobytes() for b in r[0]]
        for a, b in zip(g[1:], r[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert not got[-1][-1].all()   # the short last group repeats its last batch
    for res_dtype in (np.int8, np.float16):
        got = stack_device_batches_compact(tb, n_dev, 256, res_dtype)
        ref = jblock.stack_device_batches_compact(jb, n_dev, 256, res_dtype)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g[6] == r[6]                 # the group's largest stage
            for a, b in zip(g[1:6] + g[7:], r[1:6] + r[7:]):
                assert np.asarray(a).dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a, b)


def _jax_multichip(monkeypatch, **kw):
    """The JAX forward of TREE through its multichip path."""
    taken = []
    submit = jinf.ModelInference._submit_multichip
    monkeypatch.setattr(jinf.ModelInference, "_submit_multichip",
                        lambda self, b, n: taken.append(n) or submit(self, b, n))
    return taken, jinf.ModelInference(WEIGHTS, level_capacity_factor=1.0, **TILING, **kw)


def _port(**kw):
    return ModelInference(WEIGHTS, devices=["cpu"] * 8, level_capacity_factor=1.0, **TILING,
                          **kw)


def test_full_download_matches_jax_multichip(clouds, monkeypatch):
    cloud, jcloud = clouds
    monkeypatch.setattr(jinf, "compress_preds", lambda p: {
        "radius": p["radius"], "direction": p["direction"], "class_l": p["class_l"]})
    taken, jmi = _jax_multichip(monkeypatch, compact_transfers=False)
    ref = jmi.forward(jcloud)
    assert taken == [8]
    port = _port(compact_transfers=False)
    got, out = port.predict(cloud), port.forward(cloud)
    np.testing.assert_array_equal(got["xyz"], np.asarray(ref.xyz))   # row for row
    np.testing.assert_array_equal(got["rgb"], np.asarray(ref.rgb))
    ref_mv = np.asarray(ref.medial_vector)
    np.testing.assert_allclose(got["radius"], np.log(np.linalg.norm(ref_mv, axis=1,
                                                                    keepdims=True)),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out.medial_vector, ref_mv, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["class_logits"], np.asarray(ref.class_l).reshape(-1, 2),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("medial", [None, [0]], ids=["compact", "culled"])
def test_compact_and_culled_match_jax_multichip(clouds, monkeypatch, medial):
    cloud, jcloud = clouds
    taken, jmi = _jax_multichip(monkeypatch, medial_classes=medial)
    ref = jmi.forward(jcloud)
    assert taken == [8]
    port = _port(medial_classes=medial)
    got = port.forward(cloud)
    n = len(got)
    assert n == len(ref) > 1000
    np.testing.assert_array_equal(got.xyz, np.asarray(ref.xyz))
    np.testing.assert_array_equal(got.rgb, np.asarray(ref.rgb))
    cls, jcls = got.class_l[:, 0], np.asarray(ref.class_l)[:, 0]
    agree = cls == jcls
    assert (~agree).sum() <= FEW * n
    mv, jmv = got.medial_vector[agree], np.asarray(ref.medial_vector)[agree]
    exact = (mv == jmv).all(axis=1)
    assert (~exact).sum() <= FEW * n
    bound = (2.0 / 127 + 4e-3) * np.linalg.norm(jmv, axis=1, keepdims=True)
    assert (np.abs(mv - jmv) <= bound).all()
    if medial:
        assert (cls != 0).any()
        assert (got.medial_vector[cls != 0] == 0).all()
        assert (np.asarray(ref.medial_vector)[jcls != 0] == 0).all()


def _canonical(c):
    rows = np.concatenate([c.xyz, c.rgb, c.medial_vector, c.class_l], axis=1)
    return rows[np.lexsort(rows.T)]


@pytest.mark.parametrize("fused", [False, True], ids=["route3", "fused"])
def test_multi_device_equals_single_device_and_reaches_the_fused_route(clouds, monkeypatch,
                                                                        fused):
    cloud, _ = clouds
    calls = []
    wrapper = fused_conv.fused_gather_gemm
    monkeypatch.setattr(fused_conv, "fused_gather_gemm",
                        lambda *a: calls.append(a[0].device) or wrapper(*a))
    kw = dict(medial_classes=[0], fused=fused, precision="float32", **TILING)
    one = ModelInference(WEIGHTS, device="cpu", **kw).forward(cloud)
    single_calls = len(calls)
    two = ModelInference(WEIGHTS, devices=["cpu", "cpu"], **kw)
    runs = []
    launch = ShardedForward.launch
    monkeypatch.setattr(ShardedForward, "launch",
                        staticmethod(lambda *a: runs.append(a[3]) or launch(*a)))
    multi = two.forward(cloud)
    assert set(runs) == {"_run_batch_culled"} and len(runs) == 5   # 9 batches, 2 a group
    assert (len(calls) > single_calls > 0) if fused else not calls
    np.testing.assert_array_equal(_canonical(multi), _canonical(one))
    assert len(two._sharded.models) == 2
    assert all(m is not two.model for m in two._sharded.models)


def test_devices_argument_and_helpers(monkeypatch):
    with pytest.raises(ValueError, match="not both"):
        ModelInference(WEIGHTS, device="cpu", devices=["cpu"])
    mi = ModelInference(WEIGHTS, devices=["cpu", torch.device("cpu")])
    assert mi.device == torch.device("cpu") and len(mi.devices) == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_devices()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert make_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert len(make_devices()) == 3
    with pytest.raises(ValueError):
        make_devices(4)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert world() == (0, 1, 0)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert world() == (3, 4, 1)
