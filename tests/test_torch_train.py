"""The port's training entry point (smart_tree_tpu_torch.train.train) end to
end on the CPU, on the tiny corpus and overrides of tests/test_train_resume.py:
train, checkpoint, resume, warm start; a checkpoint the port writes read by
the JAX package (forward held at rtol 1e-3 / atol 1e-4, the model tolerance
of tests/test_torch_model.py); the default configuration against its YAML and
the JAX package's; the plateau schedule against the JAX class.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu.core.plan import build_plan as jbuild
from smart_tree_tpu.core.sparse_tensor import SparseVoxelTensor as JSVT
from smart_tree_tpu.infer.inference import model_from_variables as jmodel_from
from smart_tree_tpu.nn import convert as jconvert
from smart_tree_tpu.train.schedule import ReduceLROnPlateau as JSchedule
from smart_tree_tpu.utils import configs as jconfigs
from smart_tree_tpu_torch.core.plan import build_plan as tbuild
from smart_tree_tpu_torch.core.sparse_tensor import SparseVoxelTensor as TSVT
from smart_tree_tpu_torch.data.file import load_data_npz, save_data_npz
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.infer.inference import ModelInference
from smart_tree_tpu_torch.nn import convert as tconvert
from smart_tree_tpu_torch.train import train as train_mod
from smart_tree_tpu_torch.train.schedule import ReduceLROnPlateau as TSchedule
from smart_tree_tpu_torch.train.tracker import MetricsSink, Tracker
from smart_tree_tpu_torch.utils import configs
from tests.test_torch_model import _input


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny-trees")
    names = []
    for i in range(2):
        cloud, skel = generate_tree(seed=10 + i, height=3.0, trunk_radius=0.08,
                                    points_per_m2=800.0, foliage_points=400)
        name = f"tree_{i:03d}.npz"
        save_data_npz(str(d / name), skel, cloud)
        names.append(name)
    split = {"train": [names[0]], "validation": [names[1]], "test": [names[1]]}
    (d / "split.json").write_text(json.dumps(split))
    return d


def _overrides(corpus, out_dir, num_epoch, small_model=True):
    model = [
        "model.unet_planes=[8,16]",
        "model.radius_fc_planes=[8,4,1]",
        "model.direction_fc_planes=[8,4,3]",
        "model.class_fc_planes=[8,4,2]",
    ]
    return [
        f"directory={corpus}",
        f"json_path={corpus / 'split.json'}",
        f"output_dir={out_dir}",
        f"num_epoch={num_epoch}",
        "voxel_size=0.05",
        "spatial_shape=[96,96,96]",
        "batch_capacity=4096",
        "batch_size=2",
        "capture_output=0",
        "early_stop=False",
        "wandb.mode=disabled",
        "device=cpu",
    ] + (model if small_model else [])


@pytest.fixture(scope="module")
def first_run(tiny_corpus, tmp_path_factory):
    """One epoch through main(); (run directory, its stats, its train state)."""
    out_root = tmp_path_factory.mktemp("runs")
    stats = {}
    assert train_mod.main(_overrides(tiny_corpus, out_root, 1), stats=stats) == 0
    (run_dir,) = list(out_root.iterdir())
    with open(run_dir / "train_state.pkl", "rb") as f:
        ts = pickle.load(f)
    return run_dir, stats, ts


def test_main_trains_one_epoch_and_checkpoints(first_run):
    run_dir, stats, ts = first_run
    for name in ("variables.npz", "train_state.pkl", "best_weights.npz",
                 "last/variables.npz", "last/train_state.pkl"):
        assert (run_dir / name).is_file(), name
    assert ts["epoch"] == 0 and np.isfinite(ts["best"]) and ts["step"] > 0
    assert set(ts) == {"opt_state", "scheduler", "epoch", "best", "step"}
    assert ts["scheduler"] == {"lr": 0.01, "best": ts["best"], "num_bad": 0}
    # nothing of torch in the pickle: numpy moments keyed by parameter name
    opt = ts["opt_state"]
    assert opt["count"] == ts["step"]
    assert all(type(v) is np.ndarray for v in (*opt["mu"].values(), *opt["nu"].values()))
    assert any(v.any() for v in opt["nu"].values())
    (rec,) = stats["epochs"]
    assert stats["out_dir"] == str(run_dir)
    for phase in ("train", "val", "test"):
        assert rec[phase]["steps"] >= 1 and rec[phase]["voxels"] > 0
        assert np.isfinite(rec[phase]["total_loss"])
    assert rec["val"]["total_loss"] == pytest.approx(ts["best"])


def test_resume_with_an_empty_loop_leaves_the_checkpoint_untouched(first_run, tiny_corpus):
    run_dir, _, _ = first_run
    pkl = run_dir / "train_state.pkl"
    mtime = pkl.stat().st_mtime_ns
    last = (run_dir / "last" / "train_state.pkl").stat().st_mtime_ns
    stats = {}
    rc = train_mod.main(_overrides(tiny_corpus, run_dir.parent, 1) + [f"resume={run_dir}"],
                        stats=stats)
    assert rc == 0 and stats["epochs"] == []
    assert pkl.stat().st_mtime_ns == mtime, "resume did not restore the epoch"
    assert (run_dir / "last" / "train_state.pkl").stat().st_mtime_ns == last


def test_resume_for_one_more_epoch_advances_the_step(first_run, tiny_corpus, tmp_path):
    run_dir, _, ts = first_run
    # resume from a copy, so the module's checkpoint stays as the first run left it
    import shutil
    ckpt = tmp_path / "ckpt"
    shutil.copytree(run_dir / "last", ckpt)
    out_root = tmp_path / "runs"
    stats = {}
    rc = train_mod.main(_overrides(tiny_corpus, out_root, 2) + [f"resume={ckpt}"], stats=stats)
    assert rc == 0
    assert [r["epoch"] for r in stats["epochs"]] == [1]  # exactly one new epoch
    with open(out_root / "local-run" / "last" / "train_state.pkl", "rb") as f:
        ts2 = pickle.load(f)
    assert ts2["epoch"] == 1
    assert ts2["step"] == ts["step"] + stats["epochs"][0]["train"]["steps"]
    assert ts2["opt_state"]["count"] == ts2["step"]  # Adam went on from the loaded moments
    assert ts2["best"] <= ts["best"]


def test_checkpoint_loads_in_the_jax_package_and_forwards_equal(first_run):
    run_dir, _, _ = first_run
    variables = jconvert.load_npz(run_dir / "variables.npz")
    assert set(variables) == {"params", "batch_stats"}
    jmodel = jmodel_from(variables)
    sd = tconvert.load_npz(run_dir / "variables.npz")
    model = tconvert.load_model(sd, torch.device("cpu"))
    assert tuple(jmodel.unet_planes) == model.unet_planes == (8, 16)
    # the running statistics moved off their start: training really wrote them
    assert not torch.equal(sd["UNet.Head.sequence.1.mean"], torch.zeros(8))

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
    with torch.no_grad():
        got = model(tbuild(tx, len(model.unet_planes), min_capacity=2048), tx.feats)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_checkpoint_serves_through_model_inference(first_run, tiny_corpus):
    run_dir, _, _ = first_run
    infer = ModelInference(weights_path=run_dir / "best_weights.npz", voxel_size=0.05,
                           block_size=2.0, buffer_size=0.2, device="cpu")
    assert infer.feature_mode == "local"
    cloud, _ = load_data_npz(tiny_corpus / "tree_001.npz")
    out = infer.forward(cloud)
    assert len(out) > 100 and np.isfinite(out.medial_vector).all()


def test_variables_round_trip_is_the_flax_layout():
    path = "smart_tree_tpu/weights/synthetic-r3.npz"
    model = tconvert.load_model(tconvert.load_npz(path), torch.device("cpu"))
    ours = tconvert.variables_from_model(model)
    ref = jconvert.load_npz(path)

    def flat(tree):
        return {"/".join(p): v for p, v in jconvert._flatten(tree).items()}

    a, b = flat(ours), flat(ref)
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tconvert.flax_path("UNet.U.Encode.sequence.0.weight") == (
        "UNet", "U", "Encode.sequence", "0", "weight")
    assert tconvert.flax_path("radius_head.sequence.3.weight") == (
        "radius_head", "sequence.3.weight")
    assert tconvert.flax_path("UNet.Tail.identity.0.weight") == (
        "UNet", "Tail", "identity.0", "weight")


def test_warm_start_from_a_shipped_checkpoint(tiny_corpus, tmp_path):
    stats = {}
    argv = _overrides(tiny_corpus, tmp_path, 1, small_model=False) + [
        "warm_start=smart_tree_tpu/weights/synthetic-r3.npz"]
    assert train_mod.main(argv, stats=stats) == 0
    cold = {}
    assert train_mod.main(_overrides(tiny_corpus, tmp_path / "cold", 1, small_model=False),
                          stats=cold) == 0
    # a trained network starts far below a random one on the class loss
    warm_loss = stats["epochs"][0]["train"]["total_loss"]
    assert np.isfinite(warm_loss) and warm_loss < cold["epochs"][0]["train"]["total_loss"]
    with open(tmp_path / "local-run" / "last" / "train_state.pkl", "rb") as f:
        ts = pickle.load(f)
    assert ts["step"] == stats["epochs"][0]["train"]["steps"]  # a fresh step counter


def test_without_device_cpu_the_trainer_needs_a_card(tiny_corpus, tmp_path):
    argv = [a for a in _overrides(tiny_corpus, tmp_path, 1) if a != "device=cpu"]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(argv)
    assert not (tmp_path / "local-run").exists()


def test_default_training_equals_the_yaml_and_the_jax_yaml():
    path = configs.default_conf_dir() / "training.yaml"
    assert configs.load_yaml(path) == configs.DEFAULT_TRAINING
    fresh = configs.default_training_config()
    fresh["model"]["unet_planes"].append(128)
    assert configs.DEFAULT_TRAINING["model"]["unet_planes"] == [8, 16, 32, 64]  # a copy

    def strip(node, pkg):
        if isinstance(node, dict):
            return {k: strip(v, pkg) for k, v in node.items()}
        if isinstance(node, list):
            return [strip(v, pkg) for v in node]
        return node.replace(pkg + ".", "") if isinstance(node, str) else node

    jcfg = jconfigs.load_yaml(jconfigs.default_conf_dir() / "training.yaml")
    assert strip(configs.DEFAULT_TRAINING, "smart_tree_tpu_torch") == strip(jcfg, "smart_tree_tpu")
    # the command line composes as the JAX engine composes its own file
    ov = ["voxel_size=0.02", "model.unet_planes=[8,16]", "+device=cpu", "resume=null"]
    cfg = train_mod.load_config(ov)
    jcomposed = jconfigs.compose(jconfigs.default_conf_dir() / "training.yaml", ov)
    assert strip(cfg, "smart_tree_tpu_torch") == strip(jcomposed, "smart_tree_tpu")
    assert cfg["train_dataset"]["voxel_size"] == 0.02 and cfg["device"] == "cpu"
    assert train_mod.load_config([f"--config={path}"] + ov) == cfg


def test_override_values_parse_without_pyyaml(monkeypatch):
    import builtins
    import yaml

    cases = ["3", "0.5", "1e-3", "true", "False", "null", "[96,96,96]", "[8, 16]",
             "runs/out", "cpu", "/tmp/x.json", '"quoted"']
    want = [yaml.safe_load(c) for c in cases]
    real_import = builtins.__import__

    def no_yaml(name, *a, **kw):
        if name == "yaml":
            raise ImportError("no yaml here")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    assert [configs._parse_value(c) for c in cases] == want
    cfg = train_mod.load_config(["num_epoch=2", "spatial_shape=[96,96,96]", "device=cpu"])
    assert cfg["num_epoch"] == 2 and cfg["spatial_shape"] == [96, 96, 96]


def test_schedule_matches_the_jax_class_and_state_dicts_cross_load():
    t, j = TSchedule(lr=0.01, patience=2), JSchedule(lr=0.01, patience=2)
    values = [5.0, 4.0, 4.0, 4.1, 3.99999, 4.2, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0]
    for v in values:
        assert t.step(v) == j.step(v)
        assert t.state_dict() == j.state_dict()
    assert t.lr < 0.01
    # each package loads the other's state
    t2, j2 = TSchedule(lr=1.0, patience=2), JSchedule(lr=1.0, patience=2)
    t2.load_state_dict(j.state_dict())
    j2.load_state_dict(t.state_dict())
    assert t2.state_dict() == j2.state_dict() == t.state_dict()
    assert t2.step(9.0) == j2.step(9.0)
    tmax, jmax = TSchedule(0.1, mode="max", patience=0), JSchedule(0.1, mode="max", patience=0)
    for v in (1.0, 1.0, 2.0, 1.5):
        assert tmax.step(v) == jmax.step(v)
    assert tmax.lr == pytest.approx(0.001)


def test_tracker_means_and_sink_without_wandb():
    tr = Tracker()
    tr.update({"a": 1.0, "b": torch.tensor(3.0)})
    tr.update({"a": 3.0, "b": 1.0})
    assert tr.means == {"a": 2.0, "b": 2.0} and tr.total_loss == 4.0
    sink = MetricsSink(mode="disabled")
    assert sink.run_name == "local-run"
    assert tr.log("train", 0, sink) == tr.means
    sink.log_cloud("k", np.zeros((3, 3)))  # a no-op without wandb
    assert Tracker().total_loss == 0.0


def test_fit_smoke_learns_on_the_cpu(tiny_corpus):
    cloud, _ = load_data_npz(tiny_corpus / "tree_000.npz")
    losses = train_mod.fit_smoke(cloud, steps=4, capacity=4096, planes=(8, 16),
                                 voxel_size=0.05, device="cpu")
    assert losses.shape == (4,) and np.isfinite(losses).all() and losses[-1] < losses[0]
    again = train_mod.fit_smoke(cloud, steps=1, capacity=4096, planes=(8, 16),
                                voxel_size=0.05, device="cpu")
    assert again[0] == pytest.approx(losses[0], rel=1e-5)  # the seed fixes the weights


def test_capture_epoch_writes_both_views(first_run, tiny_corpus, tmp_path):
    pytest.importorskip("PIL")
    run_dir, _, _ = first_run
    cfg = train_mod.load_config(_overrides(tiny_corpus, tmp_path, 1))
    model = tconvert.load_model(tconvert.load_npz(run_dir / "variables.npz"),
                                torch.device("cpu"))
    state = train_mod.TrainState(model, lr=0.01)
    val_ds = configs.instantiate(cfg["validation_dataset"])
    train_mod.capture_epoch(state, val_ds, cfg, tmp_path, 3)
    from PIL import Image
    for view in ("seg", "medial"):
        img = np.asarray(Image.open(tmp_path / "captures" / f"epoch0003_{view}.png"))
        assert img.shape == (540, 960, 3) and (img != 255).any()


# ---- the numpy modules that came along: helper, metrics, render ----

def test_helper_and_metrics_match_jax():
    from smart_tree_tpu.data.cloud import Cloud as JCloud
    from smart_tree_tpu.train import helper as jhelper
    from smart_tree_tpu.train import metrics as jmetrics
    from smart_tree_tpu_torch.data.cloud import Cloud as TCloud
    from smart_tree_tpu_torch.train import helper as thelper
    from smart_tree_tpu_torch.train import metrics as tmetrics

    rng = np.random.default_rng(0)
    n = 60
    preds = {"radius": rng.normal(-3, 0.5, (n, 1)).astype(np.float32),
             "direction": rng.normal(size=(n, 3)).astype(np.float32),
             "class_l": rng.normal(size=(n, 2)).astype(np.float32)}
    feats = rng.normal(size=(n, 6)).astype(np.float32)
    coords = np.concatenate([rng.integers(0, 3, (n, 1)), rng.integers(0, 9, (n, 3))], axis=1)
    valid = rng.uniform(size=n) > 0.2
    got = thelper.to_labelled_clouds(preds, feats, coords, valid, 3, ("a", "b"))
    ref = jhelper.to_labelled_clouds(preds, feats, coords, valid, 3, ("a", "b"))
    assert len(got) == len(ref) == 3 and [c.filename for c in got] == ["a", "b", None]
    for a, b in zip(got, ref):
        for f in ("xyz", "rgb", "medial_vector", "class_l"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    pc, tc = rng.integers(0, 2, n), rng.integers(0, 2, n)
    assert tmetrics.segmentation_iou(pc, tc) == jmetrics.segmentation_iou(pc, tc)
    mv = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(2)]
    assert (tmetrics.medial_errors(TCloud(feats[:, :3], medial_vector=mv[0]),
                                   TCloud(feats[:, :3], medial_vector=mv[1]))
            == jmetrics.medial_errors(JCloud(feats[:, :3], medial_vector=mv[0]),
                                      JCloud(feats[:, :3], medial_vector=mv[1])))


def test_skeleton_distance_matches_jax():
    import copy

    from smart_tree_tpu.data.synthetic import generate_tree as jgenerate
    from smart_tree_tpu.train.metrics import skeleton_distance as jdistance
    from smart_tree_tpu_torch.train.metrics import skeleton_distance

    kw = dict(seed=4, height=2.0, trunk_radius=0.06, points_per_m2=300.0, foliage_points=50)
    pair = []
    for gen in (generate_tree, jgenerate):
        skel = gen(**kw)[1]
        moved = copy.deepcopy(skel)
        for b in moved.branches.values():
            b.xyz = b.xyz + np.float32([0.05, 0.0, 0.0])
        pair.append((skel, moved))
    for other in (0, 1):  # against itself, against the shifted copy
        got = skeleton_distance(pair[0][other], pair[0][0], device="cpu")
        ref = jdistance(pair[1][other], pair[1][0])
        assert set(got) == set(ref)
        for k in ref:  # point-to-tube distances in fp32 on both sides
            assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-6), k
    assert got["precision_dist"] > 0.01


def test_renderer_matches_jax():
    from smart_tree_tpu.viz import render as jrender
    from smart_tree_tpu_torch.viz import render as trender

    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(500, 3))
    xyz[7] = np.nan  # non-finite points are dropped
    rgb = rng.uniform(size=(500, 3))
    for kw in ({}, {"point_size": 2}, {"eye": [0.0, 1.0, 5.0], "target": [0.0, 0.0, 0.0]}):
        a = trender.Renderer(160, 90).capture(xyz, rgb, **kw)
        b = jrender.Renderer(160, 90).capture(xyz, rgb, **kw)
        assert a.shape == (90, 160, 3) and a.dtype == np.uint8 and (a != 255).any()
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trender.look_at([1, 2, 3], [0, 0, 0]),
                                  jrender.look_at([1, 2, 3], [0, 0, 0]))
    assert (trender.Renderer(8, 8).capture(np.zeros((0, 3))) == 255).all()
    cloud = generate_tree(seed=4, height=2.0, trunk_radius=0.06, points_per_m2=300.0,
                          foliage_points=50)[0]
    assert len(trender.render_labelled_cloud(cloud, [[1, 0, 0], [0, 1, 0]],
                                             trender.Renderer(64, 48))) == 3
