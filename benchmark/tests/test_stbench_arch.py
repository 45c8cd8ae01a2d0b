"""The architecture a configuration names (benchmark/arch/<arch>.py): SmartTree's
file reads exactly what the harness read before it had one, and a configuration
whose weights are a seeded draw runs correct on the CPU, the draw written once
and read by the program and the reference alike."""

import json
import time

import numpy as np
import pytest
import torch

import run
from reference.forward import Heads, forward
from reference.tiling import voxelize_cloud
from reference.unet import UNet, build_levels, load_checkpoint
from stbench import entries, flops, generator, spec, weights

from _tiny import tiny_root

torch.set_num_threads(4)
CONFIGS = ["noble58-fp32", "noble58-bf16"]


def _cfg(name):
    return json.loads((spec.BENCH_DIR / f"configs/{name}.json").read_text())


def _cloud(seed=3):
    xyz, _ = generator.generate_tree(seed=seed, height=4.0, trunk_radius=0.12,
                                     points_per_m2=1500, foliage_points=1000)
    return generator.centre(xyz)


def _old_forward(xyz, model, device="cpu", mode=None):
    """reference/forward.py's body before architectures were files."""
    vox = voxelize_cloud(xyz, model["voxel_size"], model["block_size"], model["buffer_size"])
    net = UNet(load_checkpoint(model["weights"]), device, mode)
    levels = build_levels(vox.coords, vox.side, device=device)
    order = levels[0].order.cpu().numpy()
    feats = torch.from_numpy(vox.feats[order]).to(device)
    r, d, dn, logits = (t.float().cpu().numpy() for t in net(levels, feats))
    keep = vox.interior[order]
    return Heads(vox.point[order][keep], r[keep], d[keep], dn[keep], logits[keep])


@pytest.mark.parametrize("name", CONFIGS)
def test_smart_tree_inventory_is_the_old_one(name):
    m = _cfg(name)["model"]
    assert spec.arch_name(m) == spec.DEFAULT_ARCH == "smart_tree"
    xyz = _cloud()
    vox = voxelize_cloud(xyz, m["voxel_size"], m["block_size"], m["buffer_size"])
    old = flops.inventory(build_levels(vox.coords, vox.side, device="cpu"),
                          planes=tuple(m["planes"]))
    new = spec.arch_module("smart_tree").inventory(xyz, m, "cpu")
    assert new == old and len(new) == 33 and sum(o.k3 == 27 for o in new) == 20


@pytest.mark.parametrize("name,mode", [("noble58-fp32", None), ("noble58-bf16", "fp8")])
def test_dispatched_forward_is_the_old_body_to_the_bit(name, mode):
    cfg = _cfg(name)
    model = dict(cfg["model"], weights=str(spec.ROOT / cfg["weights"]))
    xyz = _cloud(4)
    new, old = forward(xyz, model, "cpu", mode), _old_forward(xyz, model, "cpu", mode)
    for field in ("point", "log_radius", "direction", "direction_norm", "logits"):
        assert np.array_equal(getattr(new, field), getattr(old, field)), field


@pytest.mark.parametrize("name", CONFIGS)
def test_draw_has_the_checkpoints_layout(name):
    cfg = _cfg(name)
    with np.load(spec.ROOT / cfg["weights"]) as z:
        shipped = {k: z[k].shape for k in z.files}
    arch = spec.arch_module("smart_tree")
    assert arch.layout(cfg["model"]) == shipped
    drawn = arch.draw(cfg["model"], 7)
    assert {k: v.shape for k, v in drawn.items()} == shipped
    assert all(v.dtype == np.float32 and np.isfinite(v).all() for v in drawn.values())
    assert all((v > 0).all() for k, v in drawn.items() if k.endswith("/var"))


def test_drawn_heads_do_not_collapse(tmp_path):
    cfg = _cfg("noble58-fp32")
    arch = spec.arch_module("smart_tree")
    root = tiny_root(tmp_path)
    xyz = _cloud(5)
    for seed in (1, 2):
        path = weights.weights_path(dict(cfg, name="heads", weights={"seed": seed}), root)
        heads = arch.forward(xyz, dict(cfg["model"], weights=str(path)), "cpu")
        share = float((heads.logits.argmax(axis=1) == 0).mean())
        assert 0.1 < share < 0.9, share
        assert np.ptp(heads.log_radius) > 0.5 and (heads.direction_norm >= 1).mean() > 0.05


def _seeded_root(tmp_path, seed=3):
    """A tiny checkout with a float32 SmartTree configuration of weights drawn
    from `seed` and one cell of it over the small trees."""
    root = tiny_root(tmp_path)
    cfg = dict(_cfg("noble58-fp32"), name="seeded-fp32", weights={"seed": seed})
    (root / "benchmark/configs/seeded-fp32.json").write_text(json.dumps(cfg))
    limits = root / "benchmark/limits/noble58-fp32.tree-segment.json"
    (root / "benchmark/limits/seeded-fp32.tree-segment.json").write_text(limits.read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="seeded-fp32",
                                 file="benchmark/configs/seeded-fp32.json"))
    bench["workloads"].append({"name": "seeded-fp32.tree-segment", "config": "seeded-fp32",
                               "traffic": "tree-segment", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_seeded_weights_run_correct_and_are_drawn_once(tmp_path, monkeypatch):
    root = _seeded_root(tmp_path)
    cell = spec.load_cell("seeded-fp32.tree-segment", root)
    seen = []

    def recorded(cfg, root=spec.ROOT):
        seen.append(weights.weights_path(cfg, root))
        return seen[-1]

    monkeypatch.setattr(entries, "weights_path", recorded)
    monkeypatch.setattr(run, "weights_path", recorded)
    res = run.run_cell(cell, 2**31 + 11, 2.0, False, "cpu", t_start=time.perf_counter(),
                       log=lambda m: None)
    assert res["correct"], res["checks"]
    drawn = sorted(weights.weights_cache(root).iterdir())
    assert [p.suffix for p in drawn] == [".npz"] and drawn[0].name.startswith("seeded-fp32.3.")
    assert len(seen) == 2 and set(seen) == {drawn[0]}      # the program's, the reference's
    stamp = drawn[0].stat().st_mtime_ns

    arch = spec.arch_module("smart_tree", root)
    monkeypatch.setattr(arch, "draw", lambda model, seed: pytest.fail("drawn again"))
    res = run.run_cell(cell, 5, 1.0, False, "cpu", t_start=time.perf_counter(),
                       log=lambda m: None)
    assert res["correct"], res["checks"]
    assert drawn[0].stat().st_mtime_ns == stamp


def test_same_seed_same_bytes(tmp_path):
    cfg = dict(_cfg("noble58-bf16"), name="seeded-bf16")
    paths = [weights.weights_path(dict(cfg, weights={"seed": s}), tiny_root(tmp_path / d))
             for s, d in ((3, "a"), (3, "b"), (4, "c"))]
    blobs = [p.read_bytes() for p in paths]
    assert blobs[0] == blobs[1] != blobs[2]
    assert paths[0].name == paths[1].name != paths[2].name
    assert paths[0].parent == tmp_path / "a/tiny/build/benchmark_weights"
