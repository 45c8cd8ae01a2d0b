"""Port parity for the train and eval steps (smart_tree_tpu_torch.train.step)
against smart_tree_tpu.parallel.dp on a one-device mesh, so the
single-device path is the one compared.

Same parameters (carried over with params_from_jax), same compressed batch as
tests/test_multichip.py::make_batch. Gradients are read off the reference's
own step: with optax.sgd(1.0) one step moves every parameter by exactly minus
its gradient. Tolerances: losses and new batch statistics rtol 1e-4, every
parameter's gradient rtol 1e-3 / atol 1e-5 (fp32 sums in a different order
through ~10 convs and norms, forward and back), five Adam steps' total losses
rtol 2e-2 (Adam's first steps are sign-like, so last-bit gradient differences
grow).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smart_tree_tpu.infer.inference import init_template
from smart_tree_tpu.nn.model import SmartTree as JSmartTree
from smart_tree_tpu.parallel import dp as jdp
from smart_tree_tpu.parallel.mesh import make_mesh
from smart_tree_tpu_torch.core import fused_conv, slab_conv, sparse_ops
from smart_tree_tpu_torch.nn.convert import load_model, params_from_jax
from smart_tree_tpu_torch.train import step as tstep
from tests.test_multichip import make_batch

GRID, CAP, DB = 24, 256, 2
HEADS = dict(radius_fc_planes=(8, 4, 1), direction_fc_planes=(8, 4, 3),
             class_fc_planes=(8, 4, 2))


@functools.lru_cache(maxsize=None)
def _template(channels):
    jmodel = JSmartTree(input_channels=channels, unet_planes=(8, 16), bn_axis_name="dp",
                        **HEADS)
    return jmodel, init_template(jmodel)


def _setup(feature_mode, seed=0):
    jmodel, template = _template(4 if feature_mode == "local" else 3)
    variables = jax.tree.map(np.array, template)  # writable copies
    # norms away from their (1, 0, 0, 1) start, so they are really compared
    rng = np.random.default_rng(seed + 50)
    for coll, lo, hi in (("params", 0.7, 1.3), ("batch_stats", 0.5, 1.5)):
        flat = jax.tree_util.tree_flatten_with_path(variables[coll])[0]
        for path, leaf in flat:
            if leaf.ndim == 1:
                name = path[-1].key
                leaf[...] = (rng.uniform(lo, hi, leaf.shape) if name in ("scale", "var")
                             else rng.normal(0, 0.2, leaf.shape))
    batch = make_batch(np.random.default_rng(seed), 1, CAP, DB, GRID)
    tbatch = tuple(torch.from_numpy(np.array(a)) for a in batch)
    sc = tstep.StepConfig(spatial_shape=(GRID,) * 3, device_batch=DB,
                          feature_mode=feature_mode)
    return jmodel, variables, batch, tbatch, sc


def _jstate(variables, optimizer):
    return jdp.TrainState(variables["params"], variables["batch_stats"],
                          optimizer.init(variables["params"]), jnp.zeros((), jnp.int32))


def _tmodel(variables):
    return load_model(params_from_jax(variables), torch.device("cpu"))


@pytest.mark.parametrize("feature_mode", ["xyz", "local"])
def test_losses_gradients_and_batch_statistics_match_the_dp_step(feature_mode):
    jmodel, variables, batch, tbatch, sc = _setup(feature_mode)
    optimizer = optax.sgd(1.0)
    step = jdp.make_dp_train_step(jmodel, optimizer, (GRID,) * 3, DB, make_mesh(1),
                                  feature_mode=feature_mode)
    new_state, jlosses = step(_jstate(variables, optimizer), *batch)
    jgrads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                          variables["params"], new_state.params)

    model = _tmodel(variables)
    losses = tstep.compute_losses(model, tbatch, sc, train=True)
    sum(losses.values()).backward()
    for k in ("radius", "direction", "class_l"):
        np.testing.assert_allclose(float(losses[k].detach()), float(jlosses[k]), rtol=1e-4,
                                   err_msg=k)
    want = params_from_jax({"params": jgrads})
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    for name, p in named.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=name)
    stats = params_from_jax({"batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)})
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers)
    for name, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), stats[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_five_adam_steps_and_eval_step_match_the_dp_steps():
    jmodel, variables, batch, tbatch, sc = _setup("local", seed=1)
    optimizer = optax.adam(1e-2)
    mesh = make_mesh(1)
    step = jdp.make_dp_train_step(jmodel, optimizer, (GRID,) * 3, DB, mesh,
                                  feature_mode="local")
    jstate = _jstate(variables, optimizer)
    state = tstep.TrainState(_tmodel(variables), lr=1e-2)
    jhist, thist = [], []
    for _ in range(5):
        jstate, jl = step(jstate, *batch)
        jhist.append(float(sum(jax.tree.leaves(jl))))
        thist.append(float(sum(tstep.train_step(state, tbatch, sc).values())))
    assert state.step == 5 == int(jstate.step)
    np.testing.assert_allclose(thist, jhist, rtol=2e-2)
    assert all(b < a for a, b in zip(thist, thist[1:])), thist

    jeval = jdp.make_dp_eval_step(jmodel, (GRID,) * 3, DB, mesh, feature_mode="local")
    jl = jeval(jstate, *batch)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    tl = tstep.eval_step(state, tbatch, sc)
    for k in jl:
        assert not tl[k].requires_grad
        # the two trajectories are five Adam steps apart by now
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=2e-2, err_msg=k)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k  # eval leaves weights and statistics alone


@pytest.mark.parametrize("feature_mode", ["xyz", "local"])
def test_eval_step_matches_the_dp_eval_step(feature_mode):
    jmodel, variables, batch, tbatch, sc = _setup(feature_mode, seed=2)
    jeval = jdp.make_dp_eval_step(jmodel, (GRID,) * 3, DB, make_mesh(1),
                                  feature_mode=feature_mode)
    jl = jeval(_jstate(variables, optax.sgd(1.0)), *batch)
    state = tstep.TrainState(_tmodel(variables), lr=1e-2)
    tl = tstep.eval_step(state, tbatch, sc)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-4, err_msg=k)


def test_step_options_run_and_the_batch_must_be_one_device():
    _, variables, _, tbatch, sc = _setup("xyz", seed=3)
    for kw in (dict(compute_dtype=torch.bfloat16), dict(matmul_precision="bfloat16"),
               dict(direction_loss="l2raw", direction_min_radius=0.05)):
        state = tstep.TrainState(_tmodel(variables), lr=1e-2)
        out = tstep.train_step(state, tbatch, dataclasses.replace(sc, **kw))
        assert all(np.isfinite(float(v)) for v in out.values()), kw
        assert all(p.dtype == torch.float32 for p in state.model.parameters())
    two = tuple(torch.cat([a, a]) for a in tbatch)
    with pytest.raises(ValueError, match="leading axis"):
        tstep.eval_step(state, two, sc)


def test_optimizer_state_round_trip_continues_the_same_trajectory():
    _, variables, _, tbatch, sc = _setup("xyz", seed=4)
    a = tstep.TrainState(_tmodel(variables), lr=1e-2)
    for _ in range(2):
        tstep.train_step(a, tbatch, sc)
    saved = a.optimizer_state()
    assert saved["count"] == 2 and set(saved) == {"count", "mu", "nu"}
    assert all(isinstance(v, np.ndarray) for v in saved["mu"].values())
    b = tstep.TrainState(_tmodel(variables), lr=1e-2, step=a.step)
    b.model.load_state_dict(a.model.state_dict())
    b.load_optimizer_state(saved)
    c = tstep.TrainState(_tmodel(variables), lr=1e-2, step=a.step)  # weights, no moments
    c.model.load_state_dict(a.model.state_dict())
    la = tstep.train_step(a, tbatch, sc)
    lb = tstep.train_step(b, tbatch, sc)
    tstep.train_step(c, tbatch, sc)
    assert all(torch.equal(la[k], lb[k]) for k in la)
    # the CPU backward accumulates gather gradients in no fixed order, so the
    # two updates agree to rounding, not bit for bit
    moved = 0
    for (n, p), q, r in zip(a.model.named_parameters(), b.model.parameters(),
                            c.model.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
        moved += int(not np.allclose(r.detach().numpy(), p.detach().numpy(), rtol=1e-3,
                                     atol=1e-4))
    assert moved > 10  # without the moments the step is another one
    fresh = tstep.TrainState(_tmodel(variables), lr=1e-2).optimizer_state()
    assert fresh["count"] == 0 and not any(v.any() for v in fresh["mu"].values())


# ---- the hand kernels are forward-only ----

def _conv_inputs(k3=27, m=64, n=50, cin=8, cout=8, seed=0):
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32))
    rb = rng.integers(-1, n, size=(m, k3)).astype(np.int32)
    rb = torch.from_numpy(np.sort(rb, axis=0))  # columns monotone, as a real rulebook
    w = torch.from_numpy(rng.normal(size=(k3, cin, cout)).astype(np.float32))
    return feats, rb, w


@pytest.mark.parametrize("wrapper", [slab_conv.slab_gather_conv, fused_conv.fused_gather_gemm],
                         ids=["slab", "fused"])
@pytest.mark.parametrize("which", ["feats", "weights"])
def test_hand_kernel_wrappers_refuse_inputs_that_need_a_gradient(wrapper, which):
    feats, rb, w = _conv_inputs()
    plain = wrapper(feats, rb, w)  # CPU tensors, nothing requires grad: the plain version
    (feats if which == "feats" else w).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        wrapper(feats, rb, w)
    with torch.no_grad():  # fine again where autograd records nothing
        assert torch.equal(wrapper(feats, rb, w), plain)


@pytest.mark.parametrize("cfg", [sparse_ops.ConvConfig("bfloat16"),
                                 sparse_ops.ConvConfig("float32", fused=True)],
                         ids=["slab-shaped-bf16", "fused-opted-in"])
def test_gather_conv_takes_route_3_when_a_gradient_is_needed(monkeypatch, cfg):
    feats, rb, w = _conv_inputs()
    calls = []
    for mod, fn in ((slab_conv, "slab_gather_conv"), (fused_conv, "fused_gather_gemm")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _o=orig, _n=fn: calls.append(_n) or _o(*a))
    with torch.no_grad():
        hand = sparse_ops.gather_conv(feats, rb, w, cfg)
    assert len(calls) == 1  # without a gradient the conv goes to its kernel's wrapper
    w.requires_grad_(True)
    out = sparse_ops.gather_conv(feats, rb, w, cfg)
    assert len(calls) == 1 and out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), hand.numpy(), rtol=1e-5, atol=1e-5)
    out.sum().backward()
    # d(sum)/dW[k] = sum of the gathered (bf16-rounded where asked) rows
    src = sparse_ops.operand(feats, cfg.precision)
    fe = torch.cat([src, torch.zeros(1, feats.shape[1])])
    want = fe[torch.where(rb >= 0, rb, feats.shape[0]).long()].sum(dim=0)  # [K3, Cin]
    np.testing.assert_allclose(w.grad.numpy(), want[:, :, None].expand_as(w).numpy(),
                               rtol=1e-5, atol=1e-5)
