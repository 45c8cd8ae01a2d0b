"""The port's cloud readers (smart_tree_tpu_torch/data/file.py) against
smart_tree_tpu/data/file.py on the files tests/test_pcd.py writes: .pcd in
its three encodings, .xyz / .pts / .txt and .obj, through `load_cloud` and
through the port's CLI `+path`. Readers copy bytes and parse text, so every
comparison is exact.
"""

import json

import numpy as np
import pytest
import torch

from smart_tree_tpu.data import file as jfile
from smart_tree_tpu_torch import cli
from smart_tree_tpu_torch.data import file as tfile
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.infer import pipeline as tpipeline

TREE = dict(seed=3, height=2.0, trunk_radius=0.08, points_per_m2=3000.0,
            foliage_points=300)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each
    keeps OpenMP from spinning against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lzf_compress_literals(data: bytes) -> bytes:
    """A valid LZF stream of literal runs only."""
    out = bytearray()
    for i in range(0, len(data), 32):
        chunk = data[i: i + 32]
        out.append(len(chunk) - 1)
        out += chunk
    return bytes(out)


def _header(n, fields="x y z", size="4 4 4", type_="F F F", count="1 1 1", mode="binary"):
    return (
        f"# .PCD v0.7\nVERSION 0.7\nFIELDS {fields}\nSIZE {size}\n"
        f"TYPE {type_}\nCOUNT {count}\nWIDTH {n}\nHEIGHT 1\n"
        f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA {mode}\n"
    ).encode()


def _packed_rgb(rgb255):
    r, g, b = (rgb255[:, i].astype(np.uint32) for i in range(3))
    return ((r << 16) | (g << 8) | b).view(np.float32)


def write_pcd(path, xyz, rgb255=None, mode="binary"):
    """xyz [+ PCL-packed rgb] in one of the three PCD encodings."""
    cols = [xyz[:, 0], xyz[:, 1], xyz[:, 2]]
    fields, size, type_, count = "x y z", "4 4 4", "F F F", "1 1 1"
    if rgb255 is not None:
        cols.append(_packed_rgb(rgb255))
        fields, size, type_, count = "x y z rgb", "4 4 4 4", "F F F F", "1 1 1 1"
    n = len(xyz)
    with open(path, "wb") as f:
        f.write(_header(n, fields, size, type_, count, mode))
        if mode == "ascii":
            for row in zip(*cols):
                f.write((" ".join(repr(float(v)) for v in row) + "\n").encode())
        elif mode == "binary":
            f.write(np.stack(cols, axis=1).astype("<f4").tobytes())
        else:   # binary_compressed stores fields one after another (SoA)
            soa = b"".join(np.asarray(c, "<f4").tobytes() for c in cols)
            comp = _lzf_compress_literals(soa)
            f.write(np.asarray([len(comp), len(soa)], "<u4").tobytes())
            f.write(comp)


def write_text(path, xyz, rgb255=None):
    """.xyz / .txt rows, or .pts with a count line and an intensity column."""
    with open(path, "w") as f:
        if path.suffix == ".pts":
            f.write(f"{len(xyz)}\n")
        for i, row in enumerate(xyz):
            parts = [repr(float(v)) for v in row]
            if path.suffix == ".pts":
                parts.append("0.7")
            if rgb255 is not None:
                parts += [str(int(v)) for v in rgb255[i]]
            f.write(" ".join(parts) + "\n")


def write_obj(path, xyz, rgb01=None):
    with open(path, "w") as f:
        f.write("# comment\nvn 0 1 0\n")
        for i, row in enumerate(xyz):
            parts = [repr(float(v)) for v in row]
            if rgb01 is not None:
                parts += [repr(float(v)) for v in rgb01[i]]
            f.write("v " + " ".join(parts) + "\n")
        f.write("f 1 2 3\n")


def _same(got, ref):
    for f in ("xyz", "rgb"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.filename == ref.filename


@pytest.fixture(scope="module")
def cloud():
    c = generate_tree(**TREE)[0]
    rgb255 = np.round(c.rgb * 255).astype(np.uint8)
    return c.xyz[:2000].astype(np.float32), rgb255[:2000]


def test_lzf_decoder_equals_jax():
    stream = bytes([0x02]) + b"abc" + bytes([0x80, 0x02])     # literal + back reference
    assert tfile._lzf_decompress(stream, 9) == jfile._lzf_decompress(stream, 9) == b"abcabcabc"
    # a long back reference (3-bit length saturated, extension byte)
    stream = bytes([0x03]) + b"wxyz" + bytes([0xE0, 0x05, 0x03])
    assert tfile._lzf_decompress(stream, 18) == jfile._lzf_decompress(stream, 18) == \
        b"wxyz" * 4 + b"wx"
    data = np.random.default_rng(0).bytes(1000)
    assert tfile._lzf_decompress(_lzf_compress_literals(data), 1000) == data
    with pytest.raises(ValueError, match="LZF"):
        tfile._lzf_decompress(stream, 17)


@pytest.mark.parametrize("mode", ["ascii", "binary", "binary_compressed"])
@pytest.mark.parametrize("with_rgb", [False, True], ids=["xyz", "xyz+rgb"])
def test_pcd_equals_jax(tmp_path, cloud, mode, with_rgb):
    xyz, rgb255 = cloud
    path = tmp_path / "c.pcd"
    write_pcd(path, xyz, rgb255 if with_rgb else None, mode)
    got, ref = tfile.load_cloud(path), jfile.load_cloud(path)
    _same(got, ref)
    np.testing.assert_array_equal(got.xyz, xyz)
    if with_rgb:
        np.testing.assert_array_equal(np.round(got.rgb * 255), rgb255)


def test_pcd_nan_rows_dropped_and_rgb_fields(tmp_path):
    xyz = np.asarray([[0, 0, 0], [np.nan, 0, 0], [1, 1, 1]], "<f4")
    path = tmp_path / "nan.pcd"
    with open(path, "wb") as f:
        f.write(_header(3))
        f.write(xyz.tobytes())
    got = tfile.load_pcd_cloud(path)
    assert len(got.xyz) == 2
    _same(got, jfile.load_pcd_cloud(path))
    # separate uchar r g b fields and a COUNT 3 normal field
    rec = np.zeros(2, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("n", "<f4", 3),
                             ("r", "u1"), ("g", "u1"), ("b", "u1")])
    rec["x"], rec["r"], rec["b"] = [1.0, 2.0], [255, 0], [7, 9]
    path = tmp_path / "fields.pcd"
    with open(path, "wb") as f:
        f.write(_header(2, "x y z normal r g b", "4 4 4 4 1 1 1", "F F F F U U U",
                        "1 1 1 3 1 1 1"))
        f.write(rec.tobytes())
    got = tfile.load_pcd_cloud(path)
    _same(got, jfile.load_pcd_cloud(path))
    np.testing.assert_array_equal(got.rgb[0], np.asarray([255, 0, 7], np.float32) / 255)


@pytest.mark.parametrize("suffix", [".xyz", ".pts", ".txt"])
@pytest.mark.parametrize("with_rgb", [False, True], ids=["xyz", "xyz+rgb"])
def test_text_clouds_equal_jax(tmp_path, cloud, suffix, with_rgb):
    xyz, rgb255 = cloud
    path = tmp_path / f"c{suffix}"
    write_text(path, xyz, rgb255 if with_rgb else None)
    got, ref = tfile.load_cloud(path), jfile.load_cloud(path)
    _same(got, ref)
    np.testing.assert_array_equal(got.xyz, xyz)
    if not with_rgb:
        assert (got.rgb == 0).all()


@pytest.mark.parametrize("with_rgb", [False, True], ids=["xyz", "xyz+rgb"])
def test_obj_equals_jax(tmp_path, cloud, with_rgb):
    xyz, rgb255 = cloud
    path = tmp_path / "c.obj"
    write_obj(path, xyz, rgb255 / 255.0 if with_rgb else None)
    got, ref = tfile.load_cloud(path), jfile.load_cloud(path)
    _same(got, ref)
    np.testing.assert_array_equal(got.xyz, xyz)
    empty = tmp_path / "empty.obj"
    empty.write_text("# no vertices\n")
    assert len(tfile.load_obj_cloud(empty).xyz) == len(jfile.load_obj_cloud(empty).xyz) == 0


def test_other_suffixes_raise_and_load_json(tmp_path):
    path = tmp_path / "c.las"
    path.write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="unsupported cloud format .las"):
        tfile.load_cloud(path)
    split = {"train": ["a.npz"], "validation": [], "test": ["b.npz"]}
    (tmp_path / "s.json").write_text(json.dumps(split))
    assert tfile.load_json(tmp_path / "s.json") == jfile.load_json(tmp_path / "s.json") == split


@pytest.mark.parametrize("suffix", [".pcd", ".xyz", ".obj"])
def test_cli_path_reads_every_format(tmp_path, monkeypatch, suffix):
    """`run-smart-tree-torch +path=...` on each format: the pipeline gets the
    cloud the JAX reader gives and writes the four PLYs."""
    xyz, rgb255 = generate_tree(**TREE)[0].xyz, None
    path = tmp_path / f"tree{suffix}"
    {".pcd": lambda: write_pcd(path, xyz, rgb255, "binary_compressed"),
     ".xyz": lambda: write_text(path, xyz),
     ".obj": lambda: write_obj(path, xyz)}[suffix]()
    seen = []
    load = tpipeline.load_cloud
    monkeypatch.setattr(tpipeline, "load_cloud", lambda p: seen.append(load(p)) or seen[-1])
    out = tmp_path / "out"
    rc = cli.main([f"+path={path}", "pipeline.model_inference.device=cpu",
                   "pipeline.skeletonizer.device=cpu", f"pipeline.save_path={out}"])
    assert rc == 0 and len(seen) == 1
    _same(seen[0], jfile.load_cloud(path))
    for name in ("skeleton.ply", "mesh.ply", "cloud.ply", "seg_cld.ply"):
        assert tfile.ply_element_counts(out / name)["vertex"] > 0
