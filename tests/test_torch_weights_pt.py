"""Reading the reference's spconv `.pt` state_dicts
(smart_tree_tpu_torch/nn/convert.py: `load_weights`, `convert_state_dict`,
`model_from_state_dict_shapes`) against the JAX package's `load_variables`.

No checkpoint is downloaded: `_write_pt` writes a shipped `.npz` in the
reference's layout (module paths joined with dots, BatchNorm leaves weight /
bias / running_mean / running_var / num_batches_tracked, conv kernels
(Cout, kx, ky, kz, Cin)) into the test's temporary directory. Tolerances:
the weights read from the `.pt` equal the JAX package's and the `.npz`'s bit
for bit, so the port's forwards on the two files are equal bit for bit; a
warm start from either trains its first epoch to the same mean loss within
rtol 1e-5 (the CPU backward accumulates in no fixed order).
"""

import numpy as np
import pytest
import torch

from smart_tree_tpu.infer import inference as jinf
from smart_tree_tpu.nn import convert as jconvert
from smart_tree_tpu_torch.data.augmentations import CentreCloud
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.infer.inference import ModelInference
from smart_tree_tpu_torch.nn import convert as tconvert
from smart_tree_tpu_torch.train import train as train_mod
from tests.test_torch_train import _overrides, tiny_corpus  # noqa: F401 (fixture)

NPZ = "smart_tree_tpu/weights/noble-elevator-58.npz"
TREE = dict(seed=3, height=2.0, trunk_radius=0.08, points_per_m2=3000.0, foliage_points=300)


def _write_pt(npz, path):
    """The checkpoint `npz` as the reference's spconv state_dict at `path`."""
    sd = {}
    for collection, tree in jconvert.load_npz(npz).items():
        for p, v in jconvert._flatten(tree).items():
            v = np.asarray(v)
            if v.ndim == 3:                 # [K3, Cin, Cout] -> (Cout, k, k, k, Cin)
                k = round(v.shape[0] ** (1 / 3))
                v = v.reshape(k, k, k, v.shape[1], v.shape[2]).transpose(4, 0, 1, 2, 3)
            sd[jconvert.torch_key_for(p, collection)] = torch.from_numpy(v.copy())
            if collection == "batch_stats" and p[-1] == "mean":
                sd[".".join(p[:-1] + ("num_batches_tracked",))] = torch.tensor(7)
    torch.save(sd, path)
    return path


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each
    keeps OpenMP from spinning against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pt_file(tmp_path_factory):
    return _write_pt(NPZ, tmp_path_factory.mktemp("pt") / "noble-elevator-58.pt")


def test_pt_layout_is_the_reference_one(pt_file):
    sd = torch.load(pt_file, weights_only=True)
    assert sd["UNet.Head.sequence.0.weight"].shape == (8, 3, 3, 3, 8)
    assert sd["radius_head.sequence.0.weight"].shape == (8, 1, 1, 1, 8)
    assert "UNet.Head.sequence.1.running_var" in sd
    assert any(k.endswith("num_batches_tracked") for k in sd)


def test_pt_weights_equal_jax_load_variables_and_the_npz(pt_file):
    got = tconvert.load_weights(pt_file)
    ref = tconvert.params_from_jax(jinf.load_variables(pt_file))
    npz = tconvert.load_weights(NPZ)
    assert set(got) == set(ref) == set(npz)
    for k in got:
        assert torch.equal(got[k], ref[k]), k
        assert torch.equal(got[k], npz[k]), k
    jmodel = jinf.model_from_state_dict_shapes(torch.load(pt_file, weights_only=True))
    tmodel = tconvert.model_from_state_dict_shapes(torch.load(pt_file, weights_only=True))
    assert tmodel.input_channels == jmodel.input_channels
    assert tmodel.unet_planes == tuple(jmodel.unet_planes)
    for h in ("radius_head", "direction_head", "class_head"):
        assert getattr(tmodel, h).depth == len(getattr(jmodel, h.replace("head", "fc_planes")))


def test_forward_on_the_pt_equals_the_forward_on_the_npz(pt_file):
    cloud = CentreCloud()(generate_tree(**TREE)[0])
    kw = dict(device="cpu", medial_classes=[0])
    a = ModelInference(pt_file, **kw).forward(cloud)
    b = ModelInference(NPZ, **kw).forward(cloud)
    assert len(a) > 1000
    for f in ("xyz", "rgb", "medial_vector", "class_l"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_unsupported_suffix_raises_the_jax_error(tmp_path):
    bad = tmp_path / "weights.ckpt"
    bad.write_bytes(b"")
    with pytest.raises(ValueError, match="unsupported weights format") as port:
        ModelInference(bad, device="cpu")
    with pytest.raises(ValueError, match="unsupported weights format") as ref:
        jinf.load_variables(bad)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_converter_refuses_what_jax_refuses(pt_file, fault):
    sd = torch.load(pt_file, weights_only=True)
    if fault == "missing":
        del sd["UNet.Head.sequence.1.running_mean"]
        err = KeyError
    elif fault == "extra":
        sd["UNet.extra.weight"] = torch.zeros(3)
        err = ValueError
    else:
        sd["UNet.Head.sequence.1.weight"] = torch.zeros(9)
        err = ValueError
    with pytest.raises(err):
        tconvert.convert_state_dict(sd, tconvert.model_from_state_dict_shapes(sd))
    jmodel = jinf.model_from_state_dict_shapes(sd)
    with pytest.raises(err):
        jconvert.convert_state_dict(sd, jinf.init_template(jmodel))


def test_warm_start_reads_a_pt(tiny_corpus, tmp_path):  # noqa: F811
    npz = "smart_tree_tpu/weights/synthetic-r3.npz"   # the default training widths
    pt = _write_pt(npz, tmp_path / "synthetic-r3.pt")
    losses = []
    for name, weights in (("pt", pt), ("npz", npz)):
        stats = {}
        argv = _overrides(tiny_corpus, tmp_path / name, 1, small_model=False) + [
            f"warm_start={weights}"]
        assert train_mod.main(argv, stats=stats) == 0
        losses.append(stats["epochs"][0]["train"]["total_loss"])
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
