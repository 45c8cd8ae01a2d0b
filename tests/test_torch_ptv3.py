"""Point Transformer V3 on the port's normal path (nn/ptv3.py,
core/serialize.py, core/plan.py::build_serial_plan, rulebook.pooling_map)
against the plain reference tests/ptv3_reference.py, at a tiny preset on
the CPU: channels 8/16/16/32/32, depths 1/1/1/2/1, heads 8 wide, patches
of 16, blocks of a 21-voxel edge (0.05 m voxels, 0.8 m blocks, 0.1 m
buffer).

Tolerances, each as a share of the reference's largest magnitude of the
head compared (log radius, class logits, the direction head before its
normalisation):
  float32    1e-4: both sides compute in float32 with TF32 off and differ
             only in summation order (the gathers' matmuls, the attention's
             kernel against explicit products); 3e-6 was read
  bfloat16   0.15: the port rounds every product's operands to bfloat16 and
             the reference computes in float32; 0.02 to 0.05 were read, and
             the reference one precision lower (fp8 operands) reads 0.21 to
             0.42, so it fails on every head
A forward one precision lower fails each: the bfloat16 port fails the
float32 tolerance (test_tolerances_tell_the_precisions_apart).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import ptv3_reference as ref
from smart_tree_tpu_torch.core import serialize
from smart_tree_tpu_torch.core.coords import pack_coords, sort_keys, unpack_keys
from smart_tree_tpu_torch.core.memory import max_capacity_for_budget
from smart_tree_tpu_torch.core.rulebook import pooling_map
from smart_tree_tpu_torch.data.augmentations import CentreCloud
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.infer.inference import ModelInference
from smart_tree_tpu_torch.nn import ptv3
from smart_tree_tpu_torch.nn.convert import load_model, load_weights
from smart_tree_tpu_torch.nn.model import SmartTree

TINY = dict(enc_channels=(8, 16, 16, 32, 32), enc_depths=(1, 1, 1, 2, 1),
            dec_channels=(16, 16, 16, 32), dec_depths=(1, 1, 1, 1), head_dim=8,
            patch_size=16, radius_fc_planes=(16, 8, 4, 1),
            direction_fc_planes=(16, 8, 4, 3), class_fc_planes=(16, 8, 4, 2))
TILING = dict(voxel_size=0.05, block_size=0.8, buffer_size=0.1)
TOL = {"float32": 1e-4, "bfloat16": 0.15}
SMART_TREE = "smart_tree_tpu/weights/noble-elevator-58.npz"


def _npz_key(key, buffer):
    """A state_dict key's checkpoint path (the reference reads these)."""
    parts = key.split(".")
    if parts[0].endswith("_head"):
        parts = [parts[0], ".".join(parts[1:])] if parts[-1] == "weight" \
            else [parts[0], ".".join(parts[1:3]), parts[3]]
    return ("batch_stats/" if buffer else "params/") + "/".join(parts)


def draw_checkpoint(path, seed=0, **widths):
    """A seeded PTv3 checkpoint at `widths` (TINY's by default): weights
    N(0, 1 / fan in), biases and BatchNorm offsets N(0, 0.1^2), BatchNorm
    variances in [0.5, 1.5], LayerNorm at (1, 0)."""
    model = ptv3.PTv3(**dict(TINY, **widths))
    g = torch.Generator().manual_seed(seed)
    buffers = {name for name, _ in model.named_buffers()}
    kind = {name: type(m) for name, m in model.named_modules()}
    out = {"config/head_dim": np.float32(model.head_dim),
           "config/patch_size": np.float32(model.patch_size)}
    for key, t in model.state_dict().items():
        owner, leaf = key.rsplit(".", 1)
        if kind.get(owner) is ptv3.LayerNorm:
            v = torch.ones(t.shape) if leaf == "scale" else torch.zeros(t.shape)
        elif leaf == "var":
            v = 0.5 + torch.rand(t.shape, generator=g)
        elif leaf == "scale":
            v = 1.0 + 0.1 * torch.randn(t.shape, generator=g)
        elif leaf.endswith("weight"):
            v = torch.randn(t.shape, generator=g) / np.sqrt(np.prod(t.shape[:-1]))
        else:
            v = 0.1 * torch.randn(t.shape, generator=g)
        out[_npz_key(key, key in buffers)] = v.numpy().astype(np.float32)
    np.savez(path, **out)
    return path


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return draw_checkpoint(tmp_path_factory.mktemp("ptv3") / "tiny.npz")


@pytest.fixture(scope="module")
def cloud():
    return CentreCloud()(generate_tree(seed=5, height=1.6, trunk_radius=0.08,
                                       points_per_m2=800.0, foliage_points=400)[0])


def _served(path, cloud, precision, batch_size=4, **kw):
    """(forward output, [(coords [n, 4], input feats, raw heads, grid edge,
    plan)] of each UNet pass) of ModelInference.forward."""
    mi = ModelInference(str(path), batch_size=batch_size, precision=precision, device="cpu",
                        **TILING, **kw)
    passes = []
    unet = mi._unet

    def seen(x, plan):
        out = unet(x, plan)
        passes.append((unpack_keys(x.keys, x.spatial_shape, x.batch_size), x.feats.clone(),
                       {k: v.clone() for k, v in out.items()}, x.spatial_shape[0], plan))
        return out

    mi._unet = seen
    stats = {}
    out = mi.forward(cloud, stats=stats)
    return mi, out, passes, stats


def _errors(passes, net):
    """Each head's largest error against the reference over the passes, as
    a share of the reference's largest magnitude."""
    err = {}
    for coords, feats, heads, side, _ in passes:
        r, d, dn, logits = ref.forward_blocks(net, coords.numpy(), feats, side)
        for name, got, want in (("radius", heads["radius"][:, 0], r),
                                ("class", heads["class_l"], logits),
                                ("direction", heads["direction_raw"], d * dn[:, None])):
            e = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
            err[name] = max(err.get(name, 0.0), e)
    return err


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_forward_matches_the_reference(weights, cloud, precision):
    mi, out, passes, _ = _served(weights, cloud, precision, medial_classes=[0])
    assert isinstance(mi.model, ptv3.PTv3) and len(out.xyz) > 0
    assert len(passes) == len(mi.plan_rows) >= 2
    # levels shrink, and long blocks and short deep levels both occur
    assert all(r[0] > r[-1] for r in mi.plan_rows)
    err = _errors(passes, ref.PTv3(ref.load_checkpoint(weights)))
    assert max(err.values()) <= TOL[precision], err


def test_tolerances_tell_the_precisions_apart(weights, cloud):
    """The bfloat16 port fails the float32 tolerance; the reference with fp8
    operands fails the bfloat16 one."""
    _, _, passes, _ = _served(weights, cloud, "bfloat16")
    assert max(_errors(passes, ref.PTv3(ref.load_checkpoint(weights))).values()) \
        > TOL["float32"]
    _, _, passes, _ = _served(weights, cloud, "float32")
    assert max(_errors(passes, ref.PTv3(ref.load_checkpoint(weights), mode="fp8")).values()) \
        > TOL["bfloat16"]


def test_batch_size_does_not_change_a_block(weights, cloud):
    """Each block is a sample of its own: one cloud at batch_size 1 and 4
    gives the same heads for each voxel (float32 up to summation order)."""
    outs = []
    for bs in (1, 4):
        p = ModelInference(str(weights), batch_size=bs, device="cpu", **TILING).predict(cloud)
        keys = np.ascontiguousarray(p["xyz"]).view(np.dtype((np.void, 12))).ravel()
        o = np.argsort(keys)
        outs.append((keys[o], p["class_logits"][o], p["radius"][o]))
    assert len(outs[0][0]) == len(outs[1][0]) and (outs[0][0] == outs[1][0]).all()
    for a, b in zip(outs[0][1:], outs[1][1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL["float32"] * np.abs(b).max())


def test_spans_and_counters(weights, cloud):
    from torch.profiler import ProfilerActivity, profile

    mi, _, passes, stats = _served(weights, cloud, "float32", medial_classes=[0])
    assert {"infer.serialize_s", "attn_patches", "attn_pad_rows"} <= set(stats)
    # each level's patches (padded rows) once for every block at that level
    blocks = [e + d for e, d in zip(TINY["enc_depths"], TINY["dec_depths"] + (0,))]
    for key, per_level in (("attn_patches", lambda lay: lay.patches),
                           ("attn_pad_rows", lambda lay: lay.pad_rows)):
        assert stats[key] == sum(b * per_level(lv.layout) for *_, plan in passes
                                 for b, lv in zip(blocks, plan.levels))
    assert stats["attn_pad_rows"] > 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mi.forward(cloud)
    names = [e.name for e in prof.events()]
    assert names.count("infer.attention") == sum(blocks) * len(mi.plan_rows)
    assert names.count("infer.serialize") == len(TINY["enc_channels"]) * len(mi.plan_rows)


def _grid(depth):
    r = torch.arange(1 << depth)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)


@pytest.mark.parametrize("depth", [3, 4])
def test_hilbert_walks_face_neighbours(depth):
    g = _grid(depth)
    h = serialize.hilbert(g, depth)
    assert torch.equal(torch.sort(h).values, torch.arange(len(g)))      # a bijection
    walk = g[torch.argsort(h)]
    assert torch.equal((walk[1:] - walk[:-1]).abs().sum(dim=1), torch.ones(len(g) - 1,
                                                                            dtype=torch.int64))
    assert torch.equal(h, ref.hilbert_code(g, depth))       # the reference's bit loop
    # a parent's code is its children's shifted down three bits
    assert torch.equal(serialize.hilbert(g >> 1, depth - 1), h >> 3)


@pytest.mark.parametrize("depth", [1, 2, 5, 9, 10])
def test_curve_walks_match_the_reference_bit_loops(depth):
    """The table walk (three levels a lookup, a first step of depth % 3)
    against the reference's per-bit loops, past the grids walked whole."""
    c = torch.randint(0, 1 << depth, (4000, 3), generator=torch.Generator().manual_seed(depth))
    assert torch.equal(serialize.hilbert(c, depth), ref.hilbert_code(c, depth))
    assert torch.equal(serialize.z_order(c, depth), ref.z_code(c, depth))


def test_z_order_and_trans():
    c = torch.randint(0, 512, (2000, 3))
    code = serialize.z_order(c)
    want = sum(((c[:, a] >> i) & 1) << (3 * i + 2 - a) for i in range(9) for a in range(3))
    assert torch.equal(code, want) and torch.equal(code, ref.z_code(c, 9))
    b = torch.randint(0, 4, (2000,))
    codes = serialize.encode(c, b, 9)
    swapped = c[:, [1, 0, 2]]
    assert torch.equal(codes[1], serialize.z_order(swapped) | (b << 27))
    assert torch.equal(codes[3], serialize.hilbert(swapped, 9) | (b << 27))
    assert torch.equal(codes[2] >> 27, b)


def test_patch_layout_pads_from_the_rows_before():
    """An item of at most a patch is one patch of its own length; one of
    2.5 patches is padded from the rows one patch before and unpadded
    exactly."""
    counts = [40, 10, 0, 16]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]))
    lay = serialize.patch_layout(offsets, counts, 16)
    assert (lay.n_full, lay.n_short, lay.short_len, lay.pad_rows) == (3, 2, 16, 8)
    assert lay.gather[:48].tolist() == list(range(40)) + list(range(24, 32))
    assert lay.gather[48:58].tolist() == list(range(40, 50))
    assert lay.gather[64:].tolist() == list(range(50, 66))
    assert lay.short_mask.sum(dim=1).tolist() == [10, 16]
    assert torch.equal(lay.unpad, torch.cat([torch.arange(40), torch.arange(48, 58),
                                             torch.arange(64, 80)]))
    assert torch.equal(lay.gather[lay.unpad], torch.arange(66))     # each row's own slot


def test_pooling_parents_are_coords_shifted_and_max_children():
    g = torch.Generator().manual_seed(2)
    coords = torch.cat([torch.randint(0, 2, (300, 1), generator=g),
                        torch.randint(0, 21, (300, 3), generator=g)], dim=1)
    keys, _ = sort_keys(torch.unique(pack_coords(coords, (21, 21, 21), 2)))
    pkeys, first, inv, pshape = pooling_map(keys, (21, 21, 21), 2)
    n = int((pkeys != 0xFFFFFFFF).sum())
    c = unpack_keys(keys, (21, 21, 21), 2).long()
    p = unpack_keys(pkeys[:n], pshape, 2).long()
    want = torch.cat([c[:, :1], c[:, 1:] >> 1], dim=1)
    assert pshape == (11, 11, 11) and torch.equal(p[inv.long()], want)
    assert torch.unique(want, dim=0).shape[0] == n
    assert torch.equal(inv[first[:n].long()].long(), torch.arange(n))
    pool = ptv3.Pooling(4, 4)
    torch.nn.init.eye_(pool.linear.weight)
    with torch.no_grad():
        pool.linear.bias.zero_()
    pool.eval()
    x = torch.randn(len(keys), 4, generator=g)
    got = pool(x, inv.long(), n, ptv3.ConvConfig())
    mx = torch.stack([x[inv.long() == j].amax(dim=0) for j in range(n)])
    torch.testing.assert_close(got, torch.nn.functional.gelu(pool.norm(mx, None)))


def test_reference_files_are_identical():
    root = Path(__file__).resolve().parents[1]
    assert (root / "tests/ptv3_reference.py").read_bytes() == \
        (root / "benchmark/reference/ptv3.py").read_bytes()


def test_checkpoints_load_as_their_model(weights):
    st = load_model(load_weights(SMART_TREE), torch.device("cpu"))
    pt = load_model(load_weights(weights), torch.device("cpu"))
    assert type(st) is SmartTree and type(pt) is ptv3.PTv3
    assert (pt.enc_channels, pt.dec_channels, pt.head_dim, pt.patch_size, pt.stem_kernel) == \
        (TINY["enc_channels"], TINY["dec_channels"], 8, 16, 5)


def test_smart_tree_sizing_is_the_planes_model():
    mi = ModelInference(SMART_TREE, device="cpu")
    assert mi.max_batch_capacity == max_capacity_for_budget(
        mi.hbm_budget_bytes, mi.model.unet_planes, factor=1.0, in_flight=2)
