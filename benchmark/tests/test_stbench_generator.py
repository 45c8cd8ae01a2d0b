"""The benchmark's frozen generator gives the program's clouds bit for bit,
while the program keeps its generator; the pool is the seed's."""

import numpy as np
import pytest

from stbench import generator, traffic


@pytest.mark.parametrize("seed,kw", [
    (0, dict(height=3.0, points_per_m2=500.0, foliage_points=100)),
    (7, dict(height=5.0, trunk_radius=0.12, points_per_m2=800.0)),
    (2**31 + 5, dict(height=2.0, points_per_m2=300.0, foliage_points=50)),
])
def test_tree_bit_for_bit(seed, kw):
    from smart_tree_tpu_torch.data.synthetic import generate_tree

    cloud, _ = generate_tree(seed=seed, **kw)
    xyz, rgb = generator.generate_tree(seed=seed, **kw)
    assert xyz.dtype == np.float32 and np.array_equal(xyz, cloud.xyz)
    assert np.array_equal(rgb, cloud.rgb)


def test_forest_bit_for_bit():
    from smart_tree_tpu_torch.tools.bench_scan import make_forest

    cloud = make_forest(2, 200.0, seed=3)
    xyz, rgb = generator.make_forest(2, 200.0, seed=3)
    assert np.array_equal(xyz, cloud.xyz) and np.array_equal(rgb, cloud.rgb)


def test_centre_is_centre_cloud():
    from smart_tree_tpu_torch.data.augmentations import CentreCloud
    from smart_tree_tpu_torch.data.cloud import Cloud

    xyz, rgb = generator.generate_tree(seed=4, height=2.0, points_per_m2=300.0)
    xyz = xyz + np.float32(3.5)
    assert np.array_equal(generator.centre(xyz), CentreCloud()(Cloud(xyz=xyz, rgb=rgb)).xyz)


def test_pool_same_sizes_other_seeds():
    mix = dict(generator="trees", trees=2, tree_seed=5, points_per_m2=200.0, foliage_points=50)
    a = traffic.make_pool(mix, 11)
    b = traffic.make_pool(mix, 11)
    c = traffic.make_pool(mix, 2**31 + 3)
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))
    assert [len(x[0]) for x in a] == [len(x[0]) for x in c]
    assert not any(np.array_equal(x[0], y[0]) for x, y in zip(a, c))
    for x, y in zip(a, c):     # the same points, in another order
        assert np.array_equal(np.unique(x[0], axis=0), np.unique(y[0], axis=0))


def test_pool_cache_holds_the_generators_clouds(tmp_path, monkeypatch):
    mix = dict(generator="trees", trees=2, tree_seed=5, points_per_m2=200.0, foliage_points=50)
    fresh = traffic.make_pool(mix, 11)
    made = traffic.make_pool(mix, 11, tmp_path)
    assert [p.suffix for p in tmp_path.iterdir()] == [".npz"]

    def gone(p):
        raise AssertionError("the cache was not read")

    monkeypatch.setitem(traffic.GENERATORS, "trees", (gone, traffic.GENERATORS["trees"][1]))
    read = traffic.make_pool(mix, 11, tmp_path)
    for a, b, c in zip(fresh, made, read):
        assert all(np.array_equal(x, y) and np.array_equal(x, z) for x, y, z in zip(a, b, c))
    with pytest.raises(AssertionError, match="not read"):     # other parameters, another key
        traffic.make_pool(dict(mix, points_per_m2=300.0), 11, tmp_path)
