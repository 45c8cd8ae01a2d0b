"""Port parity for smart_tree_tpu_torch.train.losses against
smart_tree_tpu.train.losses on numpy inputs made from a seed: values at rtol
1e-5, gradients with respect to the predictions at rtol 1e-4 / atol 1e-6
(fp32 reductions over a few hundred rows sum in a different order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu.train import losses as jl
from smart_tree_tpu_torch.train import losses as tl

VAL = dict(rtol=1e-5, atol=1e-7)
GRAD = dict(rtol=1e-4, atol=1e-6)
N = 300


def _inputs(seed=0, masked_all=False):
    rng = np.random.default_rng(seed)
    direction = rng.normal(size=(N, 3)).astype(np.float32)
    preds = {
        "radius": rng.normal(-3, 1, size=(N, 1)).astype(np.float32),
        "direction_raw": direction,
        "direction": direction / np.linalg.norm(direction, axis=1, keepdims=True),
        "class_l": rng.normal(size=(N, 2)).astype(np.float32),
    }
    tdir = rng.normal(size=(N, 3))
    tdir /= np.linalg.norm(tdir, axis=1, keepdims=True)
    targets = np.concatenate(
        [rng.uniform(0.002, 0.1, size=(N, 1)), tdir, rng.integers(0, 2, size=(N, 1))], axis=1
    ).astype(np.float32)
    mask = np.zeros(N, bool) if masked_all else rng.uniform(size=N) > 0.3
    # padding rows as the model leaves them: all-zero predictions
    for v in preds.values():
        v[~mask] = 0.0
    return preds, targets, mask


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _both(fn_name, args_np, grad_arg=0, **kw):
    """(torch value, torch grad, jax value, jax grad) of one loss function
    with respect to argument `grad_arg`."""
    targs = [_t(a, i == grad_arg) for i, a in enumerate(args_np)]
    tv = getattr(tl, fn_name)(*targs, **kw)
    tv.backward()
    jfn = getattr(jl, fn_name)
    jv, jg = jax.value_and_grad(lambda *a: jfn(*a, **kw), argnums=grad_arg)(
        *[jnp.asarray(a) for a in args_np]
    )
    return float(tv.detach()), targs[grad_arg].grad.numpy(), float(jv), np.asarray(jg)


@pytest.mark.parametrize("name,args", [
    ("l1_loss", lambda p, t, m: (p["radius"], t[:, 0:1], m)),
    ("cosine_similarity_loss", lambda p, t, m: (p["direction"], t[:, 1:4], m)),
    ("cosine_similarity_loss", lambda p, t, m: (p["direction"], t[:, 1:4],
                                                m.astype(np.float32) * 0.25)),
    ("focal_loss", lambda p, t, m: (p["class_l"], t[:, 4], m)),
    ("l2_direction_loss", lambda p, t, m: (p["direction_raw"], t[:, 1:4], m)),
], ids=["l1", "cosine", "cosine-weighted", "focal", "l2raw"])
@pytest.mark.parametrize("masked_all", [False, True], ids=["masked", "all-masked"])
def test_loss_matches_jax(name, args, masked_all):
    tv, tg, jv, jg = _both(name, args(*_inputs(1, masked_all)))
    assert np.isfinite(tv) and np.isfinite(tg).all()
    np.testing.assert_allclose(tv, jv, **VAL)
    np.testing.assert_allclose(tg, jg, **GRAD)
    if masked_all:
        assert tv == 0.0 and not tg.any()


def test_masked_mean_matches_jax():
    rng = np.random.default_rng(2)
    x, m = rng.normal(size=50).astype(np.float32), rng.uniform(size=50) > 0.5
    np.testing.assert_allclose(float(tl._masked_mean(_t(x), _t(m))),
                               float(jl._masked_mean(jnp.asarray(x), jnp.asarray(m))), **VAL)
    assert float(tl._masked_mean(_t(x), _t(np.zeros(50, bool)))) == 0.0


@pytest.mark.parametrize("kw", [
    {},
    {"vector_class": None},
    {"target_radius_log": False},
    {"direction_loss": "l2raw", "direction_weight": 0.5},
    {"direction_min_radius": 0.02},
    {"direction_min_radius": 0.02, "direction_subvoxel_weight": 0.3, "direction_weight": 2.0},
], ids=["default", "no-vector-class", "linear-radius", "l2raw", "min-radius", "subvoxel-weight"])
@pytest.mark.parametrize("masked_all", [False, True], ids=["masked", "all-masked"])
def test_compute_loss_matches_jax(kw, masked_all):
    preds, targets, mask = _inputs(3, masked_all)
    tp = {k: _t(v, True) for k, v in preds.items()}
    tout = tl.compute_loss(tp, _t(targets), _t(mask), **kw)
    sum(tout.values()).backward()

    def jtotal(p):
        out = jl.compute_loss(p, jnp.asarray(targets), jnp.asarray(mask), **kw)
        return sum(out.values()), out

    (_, jout), jgrads = jax.value_and_grad(jtotal, has_aux=True)(
        {k: jnp.asarray(v) for k, v in preds.items()}
    )
    assert set(tout) == set(jout) == {"radius", "direction", "class_l"}
    for k in tout:
        assert np.isfinite(float(tout[k].detach()))
        np.testing.assert_allclose(float(tout[k].detach()), float(jout[k]), err_msg=k, **VAL)
    for k, p in tp.items():
        g = np.zeros_like(preds[k]) if p.grad is None else p.grad.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(jgrads[k]), err_msg=k, **GRAD)
