"""Port parity: SmartTree (smart_tree_tpu_torch/nn) against the flax model
(smart_tree_tpu/nn) on the shipped checkpoints, and the checkpoint loaders.

Same clustered 20^3-grid input as tests/test_model_parity.py, same plan
(the port's plan equals the JAX one entry for entry, test_torch_rulebook),
fp32 on both sides. Tolerance rtol 1e-3 / atol 1e-4, the model tolerance of
tests/test_model_parity.py: fp32 summation order differs through ~20
convs and batch norms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu.core.plan import build_plan as jbuild
from smart_tree_tpu.core.sparse_tensor import SparseVoxelTensor as JSVT
from smart_tree_tpu.infer.inference import load_variables
from smart_tree_tpu.infer.inference import model_from_variables as jmodel_from
from smart_tree_tpu_torch.core.plan import build_plan as tbuild
from smart_tree_tpu_torch.core.sparse_ops import ConvConfig
from smart_tree_tpu_torch.core.sparse_tensor import SparseVoxelTensor as TSVT
from smart_tree_tpu_torch.nn.convert import (
    load_model,
    load_npz,
    model_from_variables,
    params_from_jax,
)

CHECKPOINTS = ["noble-elevator-58", "synthetic-r3"]


def _path(name):
    return f"smart_tree_tpu/weights/{name}.npz"


def _input(channels, seed=0):
    rng = np.random.default_rng(seed)
    shape = (20, 20, 20)
    centers = rng.integers(3, 17, size=(6, 3))
    pts = np.concatenate([c + rng.integers(-3, 4, size=(40, 3)) for c in centers])
    pts = np.clip(pts, 0, 19)
    coords = np.unique(
        np.concatenate([np.zeros((len(pts), 1), int), pts], axis=1), axis=0
    ).astype(np.int32)
    cap = len(coords) + 13
    coords = np.concatenate([coords, np.full((cap - len(coords), 4), -1, np.int32)])
    feats = rng.normal(scale=5.0, size=(cap, channels)).astype(np.float32)
    return coords, feats, shape


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_smart_tree_matches_flax(name):
    variables = load_variables(_path(name))
    jmodel = jmodel_from(variables)
    sd = params_from_jax(variables)
    model = load_model(sd, torch.device("cpu"))
    assert model.unet_planes == tuple(jmodel.unet_planes)
    coords, feats, shape = _input(model.input_channels)
    valid = coords[:, 0] >= 0

    jx = JSVT.from_coords(jnp.asarray(coords), jnp.asarray(feats), shape, 1,
                          valid=jnp.asarray(valid))

    @jax.jit
    def jforward(x):
        plan = jbuild(x, len(jmodel.unet_planes), min_capacity=2048)
        return jmodel.apply(variables, plan, x.feats, train=False)

    ref = jforward(jx)

    tx = TSVT.from_coords(torch.from_numpy(coords), torch.from_numpy(feats), shape, 1,
                          valid=torch.from_numpy(valid))
    plan = tbuild(tx, len(model.unet_planes), min_capacity=2048)
    for lv in plan.levels:  # no level may truncate
        assert int(lv.count) <= lv.keys.shape[0]
    with torch.no_grad():
        got = model(plan, tx.feats, ConvConfig("float32"))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(ref[k]), rtol=1e-3, atol=1e-4, err_msg=k
        )


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_load_npz_equals_params_from_jax(name):
    sd = load_npz(_path(name))
    ref = params_from_jax(load_variables(_path(name)))
    assert sorted(sd) == sorted(ref)
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k
    model = model_from_variables(sd)
    # strict load: the module tree has exactly the checkpoint's entries
    assert sorted(model.state_dict()) == sorted(sd)
