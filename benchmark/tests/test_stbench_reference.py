"""The plain reference agrees with smart_tree_tpu_torch on small clouds on
the CPU: the same voxels, the same heads (float32: to the bit; bfloat16:
the program's operands rounded as the reference's "bf16" mode rounds them),
the same skeleton."""

import json

import numpy as np
import pytest
import torch

from reference import skeleton as ref_skeleton
from reference.forward import forward
from reference.tiling import voxelize_cloud
from stbench import check, entries, generator, spec

torch.set_num_threads(4)
CFG = {p: json.loads((spec.BENCH_DIR / f"configs/noble58-{p}.json").read_text())
       for p in ("fp32", "bf16")}


def _cloud(seed=3):
    xyz, rgb = generator.generate_tree(seed=seed, height=5.0, trunk_radius=0.15,
                                       points_per_m2=2000, foliage_points=2000)
    return generator.centre(xyz), rgb


def _model(cfg):
    return dict(cfg["model"], weights=str(spec.ROOT / cfg["weights"]))


def test_voxels_are_the_tilers():
    from smart_tree_tpu_torch.data.cloud import Cloud
    from smart_tree_tpu_torch.data.dataset import BlockTiler

    xyz, rgb = _cloud()
    tiler = BlockTiler(Cloud(xyz=xyz, rgb=rgb), 0.01, 4.0, 0.4)
    vox = voxelize_cloud(xyz, 0.01, 4.0, 0.4)
    theirs = sorted(map(tuple, np.concatenate(
        [b.feats[:, :3][b.interior] for b in tiler.blocks]).tolist()))
    ours = sorted(map(tuple, xyz[vox.point[vox.interior]].tolist()))
    assert ours == theirs
    assert len(vox.point) == sum(len(b.coords) for b in tiler.blocks)


@pytest.mark.parametrize("precision,mode", [("fp32", None), ("bf16", "bf16")])
def test_forward_agrees(precision, mode):
    cfg = CFG[precision]
    xyz, rgb = _cloud()
    lab, _ = entries.Segment(cfg, "cpu")(xyz, rgb)
    heads = forward(xyz, _model(cfg), "cpu", mode)
    cls, mv = check.encode_output(heads, [0])
    assert np.array_equal(np.sort(check._keys(lab.xyz)), np.sort(check._keys(xyz[heads.point])))
    order = np.argsort(check._keys(xyz[heads.point]))
    mine = np.argsort(check._keys(lab.xyz))
    assert np.array_equal(cls[order], lab.class_l.reshape(-1)[mine])
    assert np.array_equal(mv[order], lab.medial_vector[mine])
    got = check.forward_numbers(*entries.labelled_arrays(lab), xyz, heads, [0])
    assert got["rows_bad"] == 0 and got["class_flip"] == 0


def test_skeleton_agrees():
    """Branch for branch but for near-ties: the reference measures in float64
    where the program measures in float32, so a vertex whose neighbour or
    predecessor is decided within rounding may differ."""
    cfg = CFG["fp32"]
    xyz, rgb = _cloud()
    pipe = entries.PipelineEntry(cfg, "cpu")
    lab, skel = pipe(xyz, rgb)
    ref = ref_skeleton.skeletonize(*entries.labelled_arrays(lab),
                                   dict(cfg["skeletonizer"], **cfg["pipeline"]))
    assert [len(s) for s in skel] == [len(s) for s in ref] and sum(map(len, ref)) > 10
    same = sum(px.shape == rx.shape and np.allclose(px, rx, atol=2e-6)
               and np.allclose(pr, rr, atol=2e-6)
               for ps, rs in zip(skel, ref) for (px, pr), (rx, rr) in zip(ps, rs))
    assert same >= 0.95 * sum(map(len, ref))
    assert check.skeleton_miss(skel, ref) < 0.01


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_sample_largest_first_then_drawn_from_the_seed(seed):
    sizes = [3, 9, 9, 1, 5, 9]
    picks = check.sample(sizes, 3, seed)
    assert picks[0] == 1 and len(set(picks)) == 3 and picks == check.sample(sizes, 3, seed)
    assert check.sample(sizes, 1, seed) == [1] and sorted(check.sample(sizes, 9, seed)) == \
        list(range(6))
