"""Port parity for train-mode MaskedBatchNorm (smart_tree_tpu_torch.nn.norm)
against the flax module with mutable batch statistics: outputs, gradients
with respect to input, scale and bias, and the running statistics after one
and after three updates, at rtol 1e-4 (fp32 sums over the rows in a different
order; the variance is a difference of two such sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu.nn.norm import MaskedBatchNorm as JNorm
from smart_tree_tpu_torch.nn.norm import MaskedBatchNorm as TNorm

TOL = dict(rtol=1e-4, atol=1e-5)
C = 8


def _data(seed, n=200, keep=0.7, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, C)) * rng.uniform(0.5, 3, size=C) + rng.normal(size=C)).astype(dtype)
    mask = rng.uniform(size=n) < keep
    return x, mask, rng.normal(size=(n, C)).astype(np.float32)


def _modules(seed=0):
    rng = np.random.default_rng(100 + seed)
    scale = rng.uniform(0.5, 2, size=C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)
    mean = rng.normal(size=C).astype(np.float32)
    var = rng.uniform(0.5, 2, size=C).astype(np.float32)
    tm = TNorm(C)
    tm.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in
                        dict(scale=scale, bias=bias, mean=mean, var=var).items()})
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    return tm, JNorm(C), variables


@pytest.mark.parametrize("keep", [0.7, 1.0, 0.006, 0.0],
                         ids=["masked", "all-valid", "one-row", "all-masked"])
def test_train_mode_matches_flax(keep):
    x, mask, w = _data(1, keep=keep)
    if keep == 0.006:
        mask[:] = False
        mask[17] = True
    tm, jm, variables = _modules()
    tm.train()
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tm(tx, torch.from_numpy(mask))
    (ty * torch.from_numpy(w)).sum().backward()

    def jloss(params, xx):
        y, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          xx, jnp.asarray(mask), use_running_average=False,
                          mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(w)), (y, upd["batch_stats"])

    (_, (jy, jstats)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    np.testing.assert_allclose(tm.mean.numpy(), np.asarray(jstats["mean"]), **TOL)
    np.testing.assert_allclose(tm.var.numpy(), np.asarray(jstats["var"]), **TOL)
    assert not tm.mean.requires_grad and not tm.var.requires_grad
    assert torch.isfinite(ty).all() and torch.isfinite(tx.grad).all()
    if keep == 0.006:
        # one row: the variance is s2 - mean^2 of a single value, rounding
        # noise next to eps, and 1 / sqrt(var + eps) amplifies it. Only the
        # statistics (count clamp, unbiased factor) are comparable.
        return
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    scale = np.abs(np.asarray(jgx)).max()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(tm.scale.grad.numpy(), np.asarray(jgp["scale"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tm.bias.grad.numpy(), np.asarray(jgp["bias"]), **TOL)


def test_running_statistics_after_three_updates_and_eval():
    tm, jm, variables = _modules(1)
    tm.train()
    stats = variables["batch_stats"]
    for seed in (2, 3, 4):
        x, mask, _ = _data(seed)
        tm(torch.from_numpy(x), torch.from_numpy(mask))
        _, upd = jm.apply({"params": variables["params"], "batch_stats": stats},
                          jnp.asarray(x), jnp.asarray(mask), use_running_average=False,
                          mutable=["batch_stats"])
        stats = upd["batch_stats"]
    np.testing.assert_allclose(tm.mean.numpy(), np.asarray(stats["mean"]), **TOL)
    np.testing.assert_allclose(tm.var.numpy(), np.asarray(stats["var"]), **TOL)
    # eval mode reads them and leaves them alone
    x, mask, _ = _data(5)
    before = tm.mean.clone(), tm.var.clone()
    ty = tm.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    jy = jm.apply({"params": variables["params"], "batch_stats": stats}, jnp.asarray(x),
                  jnp.asarray(mask), use_running_average=True)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    assert torch.equal(tm.mean, before[0]) and torch.equal(tm.var, before[1])


def test_bf16_features_keep_fp32_statistics():
    x, mask, _ = _data(6)
    tm, jm, variables = _modules(2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ty = tm.train()(xb, torch.from_numpy(mask))
    assert ty.dtype == torch.bfloat16 and tm.mean.dtype == torch.float32
    jy, upd = jm.apply(variables, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(mask),
                       use_running_average=False, mutable=["batch_stats"])
    assert jy.dtype == jnp.bfloat16
    # one bf16 ulp on the output, fp32 tolerance on the statistics
    np.testing.assert_allclose(ty.detach().float().numpy(), np.asarray(jy.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(tm.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(tm.var.numpy(), np.asarray(upd["batch_stats"]["var"]), **TOL)


def test_state_dict_keys_are_the_flax_names():
    assert list(TNorm(4).state_dict()) == ["scale", "bias", "mean", "var"]
