"""Port parity for the slice as a whole: smart_tree_tpu_torch's Pipeline,
configuration and CLI against smart_tree_tpu's, from a cloud to the four
PLYs, plus the device rules and import hygiene of the new modules.

Tolerances: fed the SAME labelled cloud, both packages must write equal
vertex, edge and triangle counts. From the raw cloud both run their default
configuration (compact uploads, the culled fp16 / int8 download), whose
quantised payloads may differ by an fp16 ulp or an int8 step where the fp32
heads round differently, so the skeletons are held to their total length
within 2 % and the PLY vertex and face counts within 5 %.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from smart_tree_tpu.data.cloud import Cloud as JCloud
from smart_tree_tpu.utils import configs as jconfigs
from smart_tree_tpu_torch import cli
from smart_tree_tpu_torch.data.cloud import Cloud
from smart_tree_tpu_torch.data.file import ply_element_counts, save_ply_cloud
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.infer.inference import ModelInference
from smart_tree_tpu_torch.infer.pipeline import Pipeline
from smart_tree_tpu_torch.skeleton.skeletonize import Skeletonizer
from smart_tree_tpu_torch.utils import configs

REPO = Path(__file__).resolve().parent.parent
TREE = dict(seed=3, height=2.0, trunk_radius=0.08, points_per_m2=3000.0,
            foliage_points=300)
PLYS = ("skeleton.ply", "mesh.ply", "cloud.ply", "seg_cld.ply")
LENGTH_RTOL = 0.02


def _cpu_config(save_path):
    cfg = configs.default_pipeline_config()
    cfg["model_inference"]["device"] = "cpu"
    cfg["skeletonizer"]["device"] = "cpu"
    cfg["save_path"] = str(save_path)
    return cfg


def _counts(folder):
    return {name: ply_element_counts(Path(folder) / name) for name in PLYS}


@pytest.fixture(scope="module")
def raw_cloud():
    return generate_tree(**TREE)[0]


@pytest.fixture(scope="module")
def jax_run(raw_cloud, tmp_path_factory):
    """ONE run of the JAX pipeline in its default configuration (compact,
    culled transfers) from the raw cloud: its labelled cloud, skeleton and
    output folder."""
    out = tmp_path_factory.mktemp("jax_out")
    cfg = jconfigs.compose(jconfigs.default_conf_dir() / "pipeline.yaml")["pipeline"]
    cfg["save_path"] = str(out)
    pipeline = jconfigs.instantiate(cfg)
    seen = {}
    forward = pipeline.model_inference.forward

    def capture(cloud):
        seen["labelled"] = forward(cloud)
        return seen["labelled"]

    pipeline.model_inference.forward = capture
    jcloud = JCloud(xyz=raw_cloud.xyz, rgb=raw_cloud.rgb)
    skeleton = pipeline.process_cloud(cloud=jcloud)
    return dict(pipeline=pipeline, labelled=seen["labelled"], skeleton=skeleton, out=out)


@pytest.fixture(scope="module")
def port_run(raw_cloud, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_out")
    pipeline = configs.instantiate(_cpu_config(out))
    stats = {}
    skeleton = pipeline.process_cloud(cloud=Cloud(xyz=raw_cloud.xyz, rgb=raw_cloud.rgb),
                                      stats=stats)
    return dict(pipeline=pipeline, skeleton=skeleton, out=out, stats=stats)


def test_same_labelled_cloud_gives_equal_ply_counts(jax_run, tmp_path):
    """Class filter -> skeletonize -> prune / repair / smooth -> save, fed
    the labelled cloud of the one JAX inference."""
    jl = jax_run["labelled"]
    labelled = Cloud(xyz=np.asarray(jl.xyz), rgb=np.asarray(jl.rgb),
                     medial_vector=np.asarray(jl.medial_vector),
                     class_l=np.asarray(jl.class_l))
    pipeline = configs.instantiate(dict(_cpu_config(tmp_path), model_inference=None))
    skeleton = pipeline.skeletonizer.forward(labelled.filter_by_class(pipeline.branch_classes))
    pipeline.post_process(skeleton)
    pipeline.save(skeleton, labelled)
    assert _counts(tmp_path) == _counts(jax_run["out"])
    ref = jax_run["skeleton"]
    assert [len(s.branches) for s in skeleton.skeletons] == [len(s.branches) for s in ref.skeletons]
    for a, b in zip(skeleton.skeletons, ref.skeletons):
        for key, x in a.branches.items():
            y = b.branches[key]
            assert x.parent_id == y.parent_id
            # gathered medial points and box-filtered radii; the repaired
            # first vertex comes from the tube query: rtol 1e-5 / atol 1e-6
            np.testing.assert_allclose(x.xyz, y.xyz, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(x.radii, y.radii, rtol=1e-5, atol=1e-6)
    for name in ("cloud.ply", "seg_cld.ply"):  # the same labelled points, byte for byte
        assert (tmp_path / name).read_bytes() == (jax_run["out"] / name).read_bytes()


def test_whole_pipeline_matches_jax_within_two_percent(jax_run, port_run):
    got, ref = port_run["skeleton"], jax_run["skeleton"]
    assert len(got.skeletons) == len(ref.skeletons) >= 1
    got_len = sum(s.length for s in got.skeletons)
    ref_len = sum(s.length for s in ref.skeletons)
    assert ref_len > 1.0 and abs(got_len - ref_len) <= LENGTH_RTOL * ref_len
    counts, jcounts = _counts(port_run["out"]), _counts(jax_run["out"])
    assert counts["cloud.ply"] == jcounts["cloud.ply"] == counts["seg_cld.ply"]
    for name, element in (("skeleton.ply", "vertex"), ("mesh.ply", "face")):
        a, b = counts[name][element], jcounts[name][element]
        assert abs(a - b) <= 0.05 * b, (name, a, b)  # vertex counts follow the length
    stats = port_run["stats"]
    for key in ("inference_s", "skeletonize_s", "post_process_s", "save_s", "tracer_s"):
        assert stats[key] >= 0.0
    assert stats["branches"] >= sum(len(s.branches) for s in got.skeletons)


def test_saved_plys_hold_what_the_skeleton_implies(port_run):
    branches = [b for s in port_run["skeleton"].skeletons for b in s.branches.values()]
    drawn = [len(b) for b in branches if len(b) >= 2]
    counts = _counts(port_run["out"])
    assert counts["skeleton.ply"] == {"vertex": sum(drawn), "edge": sum(n - 1 for n in drawn)}
    assert counts["mesh.ply"] == {"vertex": 10 * sum(drawn),
                                  "face": 20 * sum(n - 1 for n in drawn)}


def _stand_in_heads(plan, feats, cfg):
    """Heads that are a fixed function of each voxel's input features, with
    both classes present: the network's place in test_medial_classes_semantics."""
    x = feats[:, :3].float()
    return {"radius": -3.0 + 0.1 * torch.sin(40.0 * x[:, :1]),
            "direction": torch.cat([torch.ones_like(x[:, :1]), torch.sin(30.0 * x[:, 1:])], 1),
            "class_l": torch.stack([torch.sin(25.0 * x[:, 0]), torch.cos(25.0 * x[:, 2])], 1)}


@pytest.mark.parametrize("path", ["every-class", "compact"])
def test_medial_classes_semantics(monkeypatch, path):
    """Rows whose argmax class is not in medial_classes come back with
    medial_vector = 0, the others untouched, the device culling the
    download; () means None. Listing every class culls nothing: the forward
    equals the None one bit for bit."""
    weights = "smart_tree_tpu/weights/noble-elevator-58.npz"
    rng = np.random.default_rng(0)

    def make(medial):
        mi = ModelInference(weights, device="cpu", medial_classes=medial)
        monkeypatch.setattr(mi.model, "forward", _stand_in_heads)
        return mi

    culled = make([0] if path == "compact" else (0, 1))
    everything = make(())
    assert culled.medial_classes == ((0,) if path == "compact" else (0, 1))
    assert everything.medial_classes is None  # an empty sequence means no cull
    assert ModelInference(weights, device="cpu").medial_classes is None
    cloud = Cloud(xyz=rng.uniform(0, 1, size=(5000, 3)).astype(np.float32))
    a, b = culled.forward(cloud), everything.forward(cloud)
    np.testing.assert_array_equal(a.xyz, b.xyz)
    np.testing.assert_array_equal(a.class_l, b.class_l)
    other = b.class_l[:, 0] != 0
    assert other.any() and (~other).any()
    assert (b.medial_vector != 0).any(axis=1).all()
    if path == "every-class":
        for f in ("rgb", "medial_vector"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        return
    assert (a.medial_vector[other] == 0).all()
    np.testing.assert_array_equal(a.medial_vector[~other], b.medial_vector[~other])
    # what the skeletonizer consumes is the same either way
    np.testing.assert_array_equal(a.filter_by_class([0]).medial_vector,
                                  b.filter_by_class([0]).medial_vector)


def _strip(node, prefix):
    if isinstance(node, dict):
        return {k: _strip(v, prefix) for k, v in node.items()}
    if isinstance(node, list):
        return [_strip(v, prefix) for v in node]
    if isinstance(node, str) and node.startswith(prefix + "."):
        return node[len(prefix) + 1:]
    return node


def test_default_configuration_equals_the_yaml_and_the_jax_yaml():
    cfg = configs.compose(configs.default_conf_dir() / "pipeline.yaml")
    assert list(cfg) == ["pipeline"]
    assert cfg["pipeline"] == configs.DEFAULT_PIPELINE
    jcfg = jconfigs.compose(jconfigs.default_conf_dir() / "pipeline.yaml")
    assert _strip(cfg, "smart_tree_tpu_torch") == _strip(jcfg, "smart_tree_tpu")
    fresh = configs.default_pipeline_config()
    fresh["skeletonizer"]["K"] = 3
    assert configs.DEFAULT_PIPELINE["skeletonizer"]["K"] == 16  # a copy, not the constant


def test_config_engine_matches_jax(tmp_path):
    text = ("a: {b: 3, c: '${a.b}', d: 'x${a.b}y'}\n"
            "obj: {_target_: fractions.Fraction, numerator: '${a.b}', denominator: 4}\n"
            "part: {_target_: fractions.Fraction, _partial_: true, denominator: 5}\n"
            "items: [{_target_: fractions.Fraction, numerator: 1}, 7]\n")
    (tmp_path / "c.yaml").write_text(text)
    overrides = ["a.b=6", "+new.key=[1, 2]", "a.e=hello"]
    cfg = configs.compose(tmp_path / "c.yaml", overrides)
    assert cfg == jconfigs.compose(tmp_path / "c.yaml", overrides)
    assert cfg["a"] == {"b": 6, "c": 6, "d": "x6y", "e": "hello"} and cfg["new"] == {"key": [1, 2]}
    from fractions import Fraction

    assert configs.instantiate(cfg["obj"]) == Fraction(6, 4)
    assert configs.instantiate(cfg["part"])(numerator=2) == Fraction(2, 5)
    assert configs.instantiate(cfg["items"]) == [Fraction(1), 7]
    assert configs.instantiate(cfg["obj"], denominator=3) == Fraction(2)
    (tmp_path / "d.yaml").write_text("defaults: [x]\n")
    with pytest.raises(NotImplementedError):
        configs.compose(tmp_path / "d.yaml")
    with pytest.raises(ValueError):
        configs.apply_overrides({}, ["novalue"])


@pytest.mark.parametrize("suffix", ["npz", "ply"])
def test_cli_writes_four_plys(raw_cloud, port_run, tmp_path, suffix):
    path = tmp_path / f"tree.{suffix}"
    if suffix == "npz":
        np.savez(path, xyz=raw_cloud.xyz, rgb=raw_cloud.rgb)
    else:
        save_ply_cloud(path, raw_cloud.xyz, raw_cloud.rgb)
    out = tmp_path / "out"
    rc = cli.main([f"+path={path}", "pipeline.model_inference.device=cpu",
                   "pipeline.skeletonizer.device=cpu", f"pipeline.save_path={out}"])
    assert rc == 0
    counts = _counts(out)
    if suffix == "npz":  # the same fp32 cloud as the fixture's run
        assert counts == _counts(port_run["out"])
    else:  # rgb went through uint8; xyz, and so the skeleton, did not
        assert counts["skeleton.ply"] == _counts(port_run["out"])["skeleton.ply"]


def test_cli_directory_and_usage(raw_cloud, tmp_path, capsys, monkeypatch):
    assert cli.main([]) == 1
    assert "+path=" in capsys.readouterr().out
    seen = []
    monkeypatch.setattr(Pipeline, "process_cloud", lambda self, path=None, cloud=None:
                        seen.append(Path(path).name))
    folder = tmp_path / "clouds"
    folder.mkdir()
    for name in ("b.npz", "a.npz"):
        np.savez(folder / name, xyz=raw_cloud.xyz[:10])
    rc = cli.main([f"+directory={folder}", "pipeline.model_inference.device=cpu",
                   "pipeline.skeletonizer.device=cpu"])
    assert rc == 0 and seen == ["a.npz", "b.npz"]


def test_views_warn_and_return_without_open3d(tmp_path, caplog):
    """Without open3d the views log the JAX package's warning and return, as
    its pipeline does (so a configuration with view_skeletons: True runs)."""
    from smart_tree_tpu_torch.viz import viewer

    assert not viewer.HAVE_O3D
    cfg = dict(_cpu_config(tmp_path), model_inference=None, view_skeletons=True)
    pipeline = configs.instantiate(cfg)
    with caplog.at_level("WARNING", logger=viewer.__name__):
        assert pipeline._view_skeleton(None, None) is None
        assert pipeline._view_cloud(None) is None
    assert [r.getMessage() for r in caplog.records] == [
        "open3d not available; skipping interactive view (use save_outputs: True for PLY "
        "export)"] * 2


def test_entry_points_raise_without_a_card(monkeypatch, raw_cloud, tmp_path):
    """With no card and no device="cpu", no entry point of this slice
    carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    branch = raw_cloud.filter_by_class([0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Skeletonizer().forward(branch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        configs.instantiate(configs.default_pipeline_config())
    np.savez(tmp_path / "t.npz", xyz=raw_cloud.xyz)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([f"+path={tmp_path / 't.npz'}"])
    from smart_tree_tpu_torch.neighbors.knn import knn

    with pytest.raises(RuntimeError, match="no CUDA device"):
        knn(branch.xyz[:10], branch.xyz[:10], 2, 1.0, device="cuda")
    # absent means the card
    assert Skeletonizer.__dataclass_fields__["device"].default is None


def test_import_hygiene_of_the_new_modules():
    """Importing every module of the port (the skeleton, graph, neighbors,
    viz and CLI modules included) and running the CPU pipeline's imports
    leaves jax, smart_tree_tpu and yaml-free instantiate intact."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import smart_tree_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'smart_tree_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'smart_tree_tpu', 'yaml'))\n"
        "assert not bad, bad\n"
        "need = ['neighbors.knn', 'skeleton.filter', 'skeleton.quantize', 'skeleton.graph',\n"
        "        'skeleton.path', 'skeleton.skeletonize', 'graph.table', 'graph.shortcuts',\n"
        "        'graph.components', 'graph.sssp', 'data.branch', 'data.tube', 'data.tree',\n"
        "        'utils.queries', 'utils.configs', 'viz.mesh', 'infer.pipeline', 'cli',\n"
        "        'scripts.profile_pipeline']\n"
        "missing = [n for n in need if 'smart_tree_tpu_torch.' + n not in names]\n"
        "assert not missing, missing\n"
        "from smart_tree_tpu_torch.utils.configs import default_pipeline_config, instantiate\n"
        "cfg = default_pipeline_config()\n"
        "cfg['model_inference']['device'] = cfg['skeletonizer']['device'] = 'cpu'\n"
        "instantiate(cfg)\n"
        "assert 'yaml' not in sys.modules and 'jax' not in sys.modules\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 40
