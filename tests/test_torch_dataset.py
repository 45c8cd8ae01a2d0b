"""Port parity for the training half of the host data path
(smart_tree_tpu_torch.data.{augmentations,dataset,cloud}, utils.maths and
train.train's batching) against the JAX package: numpy on both sides, so
arrays are held equal, draw for draw from one seeded Generator.
"""

import json

import numpy as np
import pytest

from smart_tree_tpu.data import augmentations as jaug
from smart_tree_tpu.data import dataset as jds
from smart_tree_tpu.data.cloud import Cloud as JCloud
from smart_tree_tpu.train import train as jtrain
from smart_tree_tpu.utils import maths as jmaths
from smart_tree_tpu_torch.data import augmentations as taug
from smart_tree_tpu_torch.data import dataset as tds
from smart_tree_tpu_torch.data.cloud import Cloud as TCloud
from smart_tree_tpu_torch.data.file import save_data_npz
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.train import train as ttrain
from smart_tree_tpu_torch.utils import maths as tmaths

FIELDS = ("xyz", "rgb", "medial_vector", "branch_direction", "branch_ids", "class_l")


@pytest.fixture(scope="module")
def tree():
    cloud, skel = generate_tree(seed=3, height=2.5, trunk_radius=0.06, points_per_m2=600.0,
                                foliage_points=300)
    return cloud, skel


def _pair(cloud):
    kw = {f: (None if getattr(cloud, f) is None else np.array(getattr(cloud, f)))
          for f in FIELDS}
    return TCloud(**kw), JCloud(**{k: (None if v is None else v.copy()) for k, v in kw.items()})


def _same_cloud(t, j):
    assert len(t) == len(j)
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)


AUGMENTATIONS = [
    ("Scale", dict(min_scale=0.9, max_scale=1.1)),
    ("FixedRotate", dict(xyz=[0.1, -0.4, 0.25])),
    ("RandomRotateY", {}),
    ("RandomScale", dict(min_scale=0.8, max_scale=1.2)),
    ("CentreCloud", {}),
    ("VoxelDownsample", dict(voxel_size=0.05)),
    ("FixedTranslate", dict(xyz=[0.5, -1.0, 2.0])),
    ("RandomCrop", dict(max_x=1.0, max_y=0.5, max_z=1.0)),
    ("RandomCubicCrop", dict(size=1.5)),
    ("RandomDropout", dict(max_drop_out=0.3)),
]


@pytest.mark.parametrize("name,kw", AUGMENTATIONS, ids=[a[0] for a in AUGMENTATIONS])
def test_augmentation_matches_jax_draw_for_draw(tree, name, kw):
    t, j = _pair(tree[0])
    rt, rj = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):  # twice: the second call starts from the advanced generator
        _same_cloud(getattr(taug, name)(**kw)(t, rt), getattr(jaug, name)(**kw)(j, rj))
    assert rt.integers(1 << 30) == rj.integers(1 << 30)  # the same number of draws


def test_training_pipeline_matches_jax(tree):
    def pipe(mod):
        return mod.AugmentationPipeline([
            mod.RandomRotateY(), mod.RandomScale(0.8, 1.2), mod.RandomCubicCrop(2.0),
            mod.RandomDropout(0.3)])
    t, j = _pair(tree[0])
    _same_cloud(pipe(taug)(t, np.random.default_rng(9)), pipe(jaug)(j, np.random.default_rng(9)))


def test_euler_rotation_and_cloud_transforms_match_jax(tree):
    np.testing.assert_array_equal(tmaths.euler_angles_to_rotation([0.3, -1.2, 2.0]),
                                  jmaths.euler_angles_to_rotation([0.3, -1.2, 2.0]))
    t, j = _pair(tree[0])
    rot = tmaths.euler_angles_to_rotation([0.0, 0.5, 0.0]).astype(np.float32)
    for op, arg in (("scale", 1.3), ("translate", np.float32([1, 2, 3])), ("rotate", rot)):
        a, b = getattr(t, op)(arg), getattr(j, op)(arg)
        _same_cloud(a, b)
        assert a.medial_vector is None and a.class_l is None  # labels dropped


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("trees")
    names = []
    for i in range(5):
        cloud, skel = generate_tree(seed=20 + i, height=2.0 + 0.3 * i, trunk_radius=0.06,
                                    points_per_m2=500.0, foliage_points=250)
        names.append(f"tree_{i}.npz")
        save_data_npz(str(d / names[-1]), skel, cloud)
    split = {"train": names[:3], "validation": names[3:4], "test": names[4:]}
    (d / "split.json").write_text(json.dumps(split))
    return d


def _datasets(corpus, mode, cache=False):
    def make(ds_mod, aug_mod):
        return ds_mod.TreeDataset(
            voxel_size=0.05, json_path=corpus / "split.json", directory=corpus, mode=mode,
            input_features=["xyz"], target_features=["radius", "direction", "class_l"],
            augmentation=aug_mod.AugmentationPipeline(
                [aug_mod.RandomRotateY(), aug_mod.RandomCubicCrop(1.5),
                 aug_mod.RandomDropout(0.2)]),
            cache=cache, seed=5)
    return make(tds, taug), make(jds, jaug)


def _same_item(a, b):
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    assert a[3] == b[3]
    np.testing.assert_array_equal(a[4], b[4])


@pytest.mark.parametrize("mode", ["train", "validation", "test"])
def test_tree_dataset_items_match_jax(corpus, mode):
    t, j = _datasets(corpus, mode, cache=(mode == "train"))
    assert len(t) == len(j) == {"train": 3, "validation": 1, "test": 1}[mode]
    first = t.item(0)
    _same_item(first, j.item(0))
    assert first[0].dtype == np.int32 and first[2].shape[1] == 5
    again = t.item(0)
    _same_item(again, j.item(0))
    # training crops move with the dataset's generator; validation and test
    # crops are a function of the index alone
    same = len(again[0]) == len(first[0]) and np.array_equal(again[0], first[0])
    assert same == (mode != "train")
    if mode == "train":
        assert len(t._cache) == 1


def test_tree_dataset_batches_and_collate_match_jax(corpus):
    t, j = _datasets(corpus, "train")
    for tb, jb in zip(t.batches(2, shuffle=True, capacity=2048),
                      j.batches(2, shuffle=True, capacity=2048), strict=True):
        for f in ("feats", "targets", "coords", "mask", "valid"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)
        assert tb.spatial_shape == jb.spatial_shape and tb.filenames == jb.filenames
        assert tb.batch_size == jb.batch_size


def test_collate_overflow_policies_match_jax(corpus, caplog):
    t, j = _datasets(corpus, "validation")
    item = t.item(0)
    n = len(item[0])
    for mod in (tds, jds):
        with pytest.raises(RuntimeError, match="collate overflow"):
            mod.collate([item], 1, capacity=n - 5)
    for policy in ("warn", "truncate"):
        tb = tds.collate([item, item], 2, capacity=n + 7, on_overflow=policy, voxel_size=0.05)
        jb = jds.collate([item, item], 2, capacity=n + 7, on_overflow=policy, voxel_size=0.05)
        assert tb.valid.all() and tb.coords[n:, 0].tolist() == [1] * 7
        for f in ("feats", "targets", "coords", "mask", "valid", "origins"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)
        for a, b in zip(tb.compressed_xyz_upload(), jb.compressed_xyz_upload()):
            np.testing.assert_array_equal(a, b)
    assert any("collate overflow" in r.message for r in caplog.records)


@pytest.mark.parametrize("sizes,budget,max_items", [
    ([5, 9, 3, 7, 7, 1], 10, 2), ([4, 4, 4, 4], 16, 4), ([12, 1], 10, 3), ([], 10, 2),
    (list(range(1, 30)), 40, 4),
])
def test_pack_bins_matches_jax(sizes, budget, max_items):
    assert ttrain._pack_bins(sizes, budget, max_items) == jtrain._pack_bins(sizes, budget,
                                                                          max_items)


@pytest.mark.parametrize("shuffle", [True, False])
def test_device_batches_match_jax(corpus, shuffle):
    t, j = _datasets(corpus, "train")
    cfg = dict(batch_size=2, batch_capacity=1024, voxel_size=0.05, input_features=["xyz"])
    got = list(ttrain._device_batches(t, cfg, 1, shuffle=shuffle))
    ref = list(jtrain._device_batches(j, cfg, 1, (64, 64, 64), shuffle=shuffle))
    assert len(got) == len(ref) >= 2
    dtypes = [np.int16, np.float16, np.float16, np.int8, np.bool_, np.float32]
    for gb, rb in zip(got, ref):
        for a, b, dt in zip(gb, rb, dtypes, strict=True):
            assert a.dtype == dt and a.shape[0] == 1
            np.testing.assert_array_equal(a, b)
    with pytest.raises(AssertionError, match="xyz only"):
        next(ttrain._device_batches(t, dict(cfg, input_features=["xyz", "rgb"])))


def test_prefetch_yields_in_order_and_surfaces_errors():
    assert list(ttrain._prefetch(iter(range(7)), depth=2)) == list(range(7))

    def broken():
        yield 1
        raise KeyError("boom")

    it = ttrain._prefetch(broken())
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)
