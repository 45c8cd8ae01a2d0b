"""Data-parallel training of the port (smart_tree_tpu_torch/parallel/dp.py,
the batch norms' `bn_group`, the trainer under a process group) against the
JAX package's `make_dp_train_step` / `make_dp_eval_step` on `make_mesh(2)`.

Two ranks run as two processes with the gloo backend, started by
`parallel.spawn_world` with a `file://` rendezvous in the test's temporary
directory; after its 120 s limit it kills the ranks and raises, so a hang
fails the test. The ranks import this
module, so JAX and the JAX package are imported inside the tests only.

Tolerances are tests/test_torch_train_step.py's: losses and new batch
statistics rtol 1e-4 (statistics atol 1e-6), gradients rtol 1e-3 /
atol 1e-5, eval losses rtol 1e-4. One Adam step (lr 1e-2) moves a parameter
by lr * g / (|g| + 1e-8), which two gradients within those tolerances move
alike only where |g| is well above 1e-8: the port's parameters equal that
step from its own gradient (atol 1e-7, Adam's rounding) everywhere, and the
JAX package's parameters (atol 1e-6) wherever |g| > 1e-4, where the two
steps differ by at most lr * 1e-8 * (1e-3 |g| + 1e-5) / g^2 ~ 1e-7. The
ranks' parameters and statistics are equal bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from smart_tree_tpu_torch.nn.convert import load_model
from smart_tree_tpu_torch.parallel import dp_eval_step, dp_train_step, spawn_world
from smart_tree_tpu_torch.train import step as tstep
from smart_tree_tpu_torch.train import train as train_mod

GRID, CAP, DB, LR = 24, 256, 2, 1e-2
HEADS = dict(radius_fc_planes=(8, 4, 1), direction_fc_planes=(8, 4, 3),
             class_fc_planes=(8, 4, 2))


def _numpy(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _rank_steps(rank, world, sd, batch, feature_mode):
    """One rank: the eval step on the given weights, then one train step."""
    torch.set_num_threads(1)
    group = dist.group.WORLD
    model = train_mod.build_model(dict(input_channels=4 if feature_mode == "local" else 3,
                                       unet_planes=(8, 16), **HEADS), bn_group=group)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    state = tstep.TrainState(model, lr=LR)
    sc = tstep.StepConfig(spatial_shape=(GRID,) * 3, device_batch=DB, feature_mode=feature_mode)
    ev = dp_eval_step(state, batch, sc, group)
    losses = dp_train_step(state, batch, sc, group)
    return dict(eval={k: float(v) for k, v in ev.items()},
                losses={k: float(v) for k, v in losses.items()},
                grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()},
                state=_numpy(model.state_dict()))


@pytest.mark.parametrize("feature_mode", ["xyz"])
def test_two_rank_steps_match_the_jax_dp_steps(tmp_path, feature_mode):
    import jax
    import optax

    from smart_tree_tpu.parallel import dp as jdp
    from smart_tree_tpu.parallel.mesh import make_mesh
    from smart_tree_tpu_torch.nn.convert import params_from_jax
    from tests.test_multichip import make_batch
    from tests.test_torch_train_step import _jstate, _setup

    jmodel, variables, _, _, _ = _setup(feature_mode, seed=5)
    batch = tuple(np.array(a) for a in make_batch(np.random.default_rng(5), 2, CAP, DB, GRID))
    mesh = make_mesh(2)
    spatial = (GRID,) * 3

    jeval = jdp.make_dp_eval_step(jmodel, spatial, DB, mesh, feature_mode=feature_mode)
    jev = jeval(_jstate(variables, optax.sgd(1.0)), *batch)
    sgd = jdp.make_dp_train_step(jmodel, optax.sgd(1.0), spatial, DB, mesh,
                                 feature_mode=feature_mode)
    after_sgd, jlosses = sgd(_jstate(variables, optax.sgd(1.0)), *batch)
    jgrads = params_from_jax({"params": jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                                     variables["params"], after_sgd.params)})
    jstats = params_from_jax({"batch_stats": jax.tree.map(np.asarray, after_sgd.batch_stats)})
    adam = jdp.make_dp_train_step(jmodel, optax.adam(LR), spatial, DB, mesh,
                                  feature_mode=feature_mode)
    after_adam, _ = adam(_jstate(variables, optax.adam(LR)), *batch)
    jparams = params_from_jax({"params": jax.tree.map(np.asarray, after_adam.params)})

    sd = _numpy(load_model(params_from_jax(variables), torch.device("cpu")).state_dict())
    ranks = spawn_world(_rank_steps, 2, f"file://{tmp_path / 'rendezvous'}",
                        args=(sd, batch, feature_mode))
    a, b = ranks
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k], err_msg=k)
    assert a["losses"] == b["losses"] and a["eval"] == b["eval"]
    for k in jev:
        np.testing.assert_allclose(a["eval"][k], float(jev[k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(a["losses"][k], float(jlosses[k]), rtol=1e-4, err_msg=k)
    assert set(a["grads"]) == set(jgrads) == set(jparams)
    for name, g in a["grads"].items():
        jg = jgrads[name].numpy()
        np.testing.assert_allclose(g, jg, rtol=1e-3, atol=1e-5, err_msg=name)
        # the port's Adam step from its own gradient
        np.testing.assert_allclose(a["state"][name], sd[name] - LR * g / (np.abs(g) + 1e-8),
                                   rtol=0, atol=1e-7, err_msg=name)
        big = np.abs(jg) > 1e-4
        np.testing.assert_allclose(a["state"][name][big], jparams[name].numpy()[big], rtol=0,
                                   atol=1e-6, err_msg=name)
    for name, v in jstats.items():
        np.testing.assert_allclose(a["state"][name], v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    # the statistics really crossed the ranks: each rank's own batch gives others
    alone = load_model(params_from_jax(variables), torch.device("cpu")).train()
    sc = tstep.StepConfig(spatial_shape=spatial, device_batch=DB, feature_mode=feature_mode)
    with torch.no_grad():
        tstep.compute_losses(alone, tuple(torch.from_numpy(x[:1]) for x in batch), sc, True)
    name = "UNet.Head.sequence.1.mean"
    assert not np.allclose(alone.state_dict()[name].numpy(), a["state"][name], rtol=1e-4)


def test_one_rank_without_a_group_is_the_one_device_step():
    """dp_train_step / dp_eval_step with no group are train_step / eval_step
    bit for bit (one torch thread: the CPU backward then accumulates in a
    fixed order)."""
    from tests.test_torch_train_step import _setup, _tmodel

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, variables, batch, tbatch, sc = _setup("local", seed=6)
        a = tstep.TrainState(_tmodel(variables), lr=LR)
        b = tstep.TrainState(_tmodel(variables), lr=LR)
        for _ in range(2):
            la = tstep.train_step(a, tbatch, sc)
            lb = dp_train_step(b, tuple(np.array(x) for x in batch), sc)
            assert all(torch.equal(la[k], lb[k]) for k in la)
        for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
            assert torch.equal(v, w), k
        ea, eb = tstep.eval_step(a, tbatch, sc), dp_eval_step(b, tbatch, sc)
        assert all(torch.equal(ea[k], eb[k]) for k in ea)
    finally:
        torch.set_num_threads(n)


def _rank_main(rank, world, argv_by_rank):
    """One rank of the trainer, in the process group the caller made."""
    torch.set_num_threads(1)
    stats = {}
    assert train_mod.main(argv_by_rank[rank], stats=stats) == 0
    return stats["epochs"]


def test_trainer_on_two_ranks(tmp_path):
    import json

    from smart_tree_tpu_torch.data.file import save_data_npz
    from smart_tree_tpu_torch.data.synthetic import generate_tree
    from tests.test_torch_train import _overrides

    names = []
    for i in range(3):   # the corpus of tests/test_torch_train.py, one more train tree
        cloud, skel = generate_tree(seed=10 + i, height=3.0, trunk_radius=0.08,
                                    points_per_m2=800.0, foliage_points=400)
        names.append(f"tree_{i:03d}.npz")
        save_data_npz(str(tmp_path / names[-1]), skel, cloud)
    split = {"train": names[:2], "validation": names[2:], "test": names[2:]}
    (tmp_path / "split.json").write_text(json.dumps(split))
    argv = [_overrides(tmp_path, tmp_path / f"rank{r}", 2) for r in range(2)]
    epochs = spawn_world(_rank_main, 2, f"file://{tmp_path / 'rendezvous'}", args=(argv,))
    # every rank logged the same averaged losses, epoch by epoch
    keys = ("total_loss", "steps", "voxels")
    for e0, e1 in zip(*epochs):
        for phase in ("train", "val", "test"):
            assert [e0[phase][k] for k in keys] == [e1[phase][k] for k in keys]
    assert len(epochs[0]) == 2 and np.isfinite(epochs[0][-1]["train"]["total_loss"])
    # batch_size 2 over two ranks: one item a row, both train trees in one step
    assert epochs[0][0]["train"]["steps"] == 1
    # rank 0 alone writes
    run = tmp_path / "rank0" / "local-run"
    assert (run / "last" / "variables.npz").is_file() and (run / "best_weights.npz").is_file()
    assert not (tmp_path / "rank1").exists()
