"""Port parity for the transfer path of ModelInference.forward
(smart_tree_tpu_torch/infer/inference.py), with `medial_classes=None` held
against the JAX package's compact mode and `medial_classes=[0]` against its
culled one, and the host pieces it stands on: the host key packing, the
compact uploads of VoxelBatch, the quantised payload, the device-side pad,
one run and one key sort a batch (exact plans) and the in-flight window.

Tolerances of the forward parity (both packages compute fp32 heads that
agree within rtol 1e-3 / atol 1e-4, then both quantise them):
  - class equal on every row whose two fp32 logits differ by more than 1e-3
    (the port's logits); rows nearer a tie are counted and must be few;
  - radius within 1 fp16 ulp, each direction component within one 1/127
    step (before renormalisation), on every row;
  - a row whose quantised payload is bit-equal has a bit-equal medial vector
    (both hosts decode it with the same numpy code); rows that are not are
    counted and must be few;
  - culled against compact: equal on branch-class rows, exactly 0 elsewhere.

The JAX forwards run once per weight kind and mode (module-scoped fixture)
on one tree that tiles into ONE batch, so the conftest's 8 CPU devices do not
send JAX down its multichip path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smart_tree_tpu.infer.inference as jinf
from smart_tree_tpu.core import coords as jcoords
from smart_tree_tpu.data import dataset as jds
from smart_tree_tpu.data.augmentations import CentreCloud as JCentre
from smart_tree_tpu.data.synthetic import generate_tree as jgenerate
from smart_tree_tpu_torch.core import coords as tcoords
from smart_tree_tpu_torch.core import tiler
from smart_tree_tpu_torch.data import dataset as tds
from smart_tree_tpu_torch.data.augmentations import CentreCloud
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.infer import inference as tinf
from smart_tree_tpu_torch.infer.inference import ModelInference

TREE = dict(seed=3, height=2.0, trunk_radius=0.08, points_per_m2=3000.0,
            foliage_points=300)
# absolute-xyz features take int8 residuals; 'local' features (input
# channels 4) keep fp16. synthetic-r3 also predicts both classes on TREE, so
# the cull has rows to zero.
WEIGHTS = {
    "int8": "smart_tree_tpu/weights/noble-elevator-58.npz",
    "fp16": "smart_tree_tpu/weights/synthetic-r3.npz",
}
TIE_GAP = 1e-3
FEW = 0.01   # share of rows allowed outside the exact-payload / clear-class sets


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each
    keeps OpenMP from spinning against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clouds():
    return CentreCloud()(generate_tree(**TREE)[0]), JCentre()(jgenerate(**TREE)[0])


def _one_batch(tiler, mi):
    batches = list(tiler.batches(4, max_capacity=mi.max_batch_capacity))
    assert len(batches) == 1
    return batches[0]


# ---------------------------------------------------------------- host keys

@pytest.mark.parametrize("spatial,batch", [((37, 41, 29), 5), ((481, 481, 481), 4)])
def test_pack_coords_np_bit_equal_to_jax_and_device(spatial, batch):
    rng = np.random.default_rng(0)
    n = 4096
    coords = np.concatenate([
        rng.integers(-1, batch + 1, size=(n, 1)),                    # incl. out of range
        rng.integers(-2, max(spatial) + 3, size=(n, 3)),             # incl. out of grid
    ], axis=1).astype(np.int32)
    coords[: n // 4] = coords[n // 4: n // 2]                        # duplicate rows
    valid = rng.random(n) < 0.8
    hk = tcoords.pack_coords_np(coords, spatial, batch, valid=valid)
    assert hk.dtype == np.uint32
    np.testing.assert_array_equal(hk, jcoords.pack_coords_np(coords, spatial, batch, valid=valid))
    dk = tcoords.pack_coords(torch.from_numpy(coords), spatial, batch, valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(hk.astype(np.int64), dk.numpy())
    # the int32 bit patterns the compact upload sends widen back to the keys
    widened = torch.from_numpy(hk.view(np.int32)).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(widened, dk)
    # the host's stable order is the device's
    order = np.argsort(hk, kind="stable")
    np.testing.assert_array_equal(order, torch.sort(dk, stable=True).indices.numpy())
    n_act = int((hk != tcoords.INVALID_KEY).sum())
    assert (hk[order[:n_act]] != tcoords.INVALID_KEY).all()
    assert (hk[order[n_act:]] == tcoords.INVALID_KEY).all()


def test_ravel_hash_np_matches_jax():
    x = np.random.default_rng(1).integers(-50, 50, size=(500, 3))
    np.testing.assert_array_equal(tcoords.ravel_hash_np(x), jcoords.ravel_hash_np(x))
    with pytest.raises(ValueError):
        tcoords.ravel_hash_np(x[:, 0])


# ---------------------------------------------------------------- uploads

@pytest.fixture(scope="module")
def tiled():
    """The TREE batch of both packages (both dedup through the native hash,
    so the batches are equal array for array)."""
    cloud, jcloud = _clouds()
    tt = tds.BlockTiler(cloud, 0.01, 4.0, 0.4)
    jt = jds.BlockTiler(jcloud, 0.01, 4.0, 0.4)
    (tb,) = list(tt.batches(4, max_capacity=262144))
    (jb,) = list(jt.batches(4, max_capacity=262144))
    # a mask with holes, as interior masks of several blocks have
    hole = np.random.default_rng(3).random(len(tb.mask)) < 0.3
    tb.mask[hole] = False
    jb.mask[hole] = False
    return tb, jb


def test_tiled_batches_equal_jax(tiled):
    tb, jb = tiled
    for f in ("feats", "coords", "mask", "valid", "origins"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)
    assert (tb.spatial_shape, tb.batch_size, tb.voxel_size) == \
        (jb.spatial_shape, jb.batch_size, jb.voxel_size)
    assert tb.n_valid == jb.n_valid == int(tb.valid.sum())


@pytest.mark.parametrize("granularity", [256, 4096])
@pytest.mark.parametrize("res_dtype", [np.int8, np.float16], ids=["int8", "fp16"])
@pytest.mark.parametrize("kind", ["unsorted", "sorted", "sorted+mask"])
def test_compact_uploads_equal_jax(tiled, kind, res_dtype, granularity):
    tb, jb = tiled
    if kind == "unsorted":
        got = tb.compact_upload(granularity, res_dtype)
        ref = jb.compact_upload(granularity, res_dtype)
    else:
        mask = kind == "sorted+mask"
        got = tb.compact_upload_sorted(granularity, res_dtype, with_mask=mask)
        ref = jb.compact_upload_sorted(granularity, res_dtype, with_mask=mask)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    stage = len(got[0])
    assert stage % granularity == 0 or stage == len(tb.coords)
    assert np.asarray(got[1]).dtype == res_dtype


def test_int8_residuals_step_by_voxel_over_254(tiled):
    tb, _ = tiled
    c16, q, orig, n = tb.compact_upload(4096, np.int8)
    centre = orig[c16[:n, 0]] + (c16[:n, 1:].astype(np.float32) + 0.5) * tb.voxel_size
    rec = centre + q[:n].astype(np.float32) * (tb.voxel_size / 254.0)
    np.testing.assert_allclose(rec, tb.feats[:n, :3], atol=tb.voxel_size / 254.0)


def test_n_valid_raises_when_valid_rows_are_not_a_prefix(tiled):
    tb, _ = tiled
    valid = tb.valid.copy()
    valid[0] = False
    with pytest.raises(ValueError, match="prefix"):
        tb._replace(valid=valid).n_valid


# ---------------------------------------------------------------- payload

def test_compress_preds_and_decode_direction_equal_jax():
    rng = np.random.default_rng(2)
    n = 3000
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:40] = (np.arange(-20, 20, dtype=np.float32)[:, None] + 0.5) / 127.0  # ties of the rounding
    d[40:50] = np.float32(1.5)                                             # past the clip
    preds = {"radius": rng.normal(-3, 1, size=(n, 1)).astype(np.float32), "direction": d,
             "class_l": rng.normal(size=(n, 2)).astype(np.float32)}
    preds["class_l"][:30, 1] = preds["class_l"][:30, 0]                    # argmax ties
    got = tinf.compress_preds({k: torch.from_numpy(v) for k, v in preds.items()})
    ref = jinf.compress_preds({k: jnp.asarray(v) for k, v in preds.items()})
    for k in ("radius", "direction", "class_l"):
        a, b = got[k].numpy(), np.asarray(ref[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    q = rng.integers(-127, 128, size=(n, 3)).astype(np.int8)
    q[:5] = 0
    np.testing.assert_array_equal(tinf.decode_direction(q), jinf.decode_direction(q))


@pytest.mark.parametrize("kind", ["int8", "fp16"])
def test_device_pad_of_the_sorted_upload_equals_jax(tiled, kind):
    tb, jb = tiled
    port = ModelInference(WEIGHTS[kind], device="cpu")
    jmi = jinf.ModelInference(WEIGHTS[kind])
    skeys, res, _, _ = tb.compact_upload_sorted(4096, port.res_dtype)
    cap = len(tb.coords)
    keys, r = port._pad_sorted(torch.from_numpy(skeys.view(np.int32)), torch.from_numpy(res), cap)
    jk, jr = jmi._pad_fn_sorted(len(skeys), cap, kind == "int8")(skeys, res)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jk).astype(np.int64))
    assert r.dtype == torch.float16
    np.testing.assert_array_equal(r.numpy().view(np.uint16), np.asarray(jr).view(np.uint16))


# ---------------------------------------------------------------- forwards

@pytest.fixture(scope="module", params=["int8", "fp16"])
def runs(request):
    """The port's and JAX's compact and culled forwards of TREE with one
    weight kind, the quantised payload of each package's last (not
    overflowing) run and the port's fp32 class logits."""
    weights = WEIGHTS[request.param]
    cloud, jcloud = _clouds()
    port = ModelInference(weights, device="cpu")
    assert port.medial_classes is None
    assert port.res_dtype == (np.int8 if request.param == "int8" else np.float16)
    vb = _one_batch(tds.BlockTiler(cloud, 0.01, 4.0, 0.4), port)
    captured = []
    compress = tinf.compress_preds

    def capture(preds):
        q = compress(preds)
        captured.append((preds["class_l"].float().numpy().copy(),
                         {k: v.numpy().copy() for k, v in q.items()}))
        return q

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tinf, "compress_preds", capture)
        compact = port.forward(cloud)
    port_culled = ModelInference(weights, device="cpu", medial_classes=[0])
    culled = port_culled.forward(cloud)

    jmi = jinf.ModelInference(weights)      # the JAX defaults: compact transfers
    jvb = _one_batch(jds.BlockTiler(jcloud, 0.01, 4.0, 0.4), jmi)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinf.ModelInference, "_submit_multichip",
                   lambda *a, **k: pytest.fail("took the multichip path"))
        jcompact = jmi.forward(jcloud)
        jmi.medial_classes = (0,)           # same compiled forward, culled download
        jculled = jmi.forward(jcloud)
    jp, counts, caps = jmi._run_batch_compact(jvb)
    while np.any(np.asarray(counts) > np.asarray(caps)):    # the retries forward() ran
        jp, counts, caps = jmi._run_batch_compact(jvb, level_caps=jmi._retry_caps(counts, caps))
    order = np.argsort(tcoords.pack_coords_np(vb.coords, vb.spatial_shape, vb.batch_size,
                                              valid=vb.valid), kind="stable")
    n_act = int(vb.valid.sum())
    logits, payload = captured[-1]
    return dict(
        kind=request.param, vb=vb, bytes={"compact": port.link_bytes,
                                          "culled": port_culled.link_bytes},
        compact=compact, culled=culled, jcompact=jcompact, jculled=jculled,
        payload={k: v[:n_act] for k, v in payload.items()},
        jpayload={k: np.asarray(v)[:n_act] for k, v in jp.items()},
        logits=logits[:n_act],
        # output rows of the forward = the interior rows of the sorted prefix
        out_rows=np.flatnonzero(vb.mask[order[:n_act]]),
    )


def _payload_agreement(runs):
    """Per-row checks of the port's quantised payload against JAX's at the
    stated bounds; returns (rows with a bit-equal payload, near-tie rows)."""
    p, j, logits = runs["payload"], runs["jpayload"], runs["logits"]
    rp, rj = p["radius"][:, 0], j["radius"][:, 0]
    ulp = np.spacing(np.maximum(np.abs(rp), np.abs(rj)))     # fp16 spacing
    assert (np.abs(rp.astype(np.float32) - rj.astype(np.float32)) <= ulp).all()
    step = np.abs(p["direction"].astype(np.int32) - j["direction"].astype(np.int32))
    assert step.max() <= 1
    clear = np.abs(logits[:, 0] - logits[:, 1]) > TIE_GAP
    np.testing.assert_array_equal(p["class_l"][clear], j["class_l"][clear])
    same = (rp == rj) & (step.max(axis=1) == 0) & (p["class_l"] == j["class_l"])
    n = len(rp)
    assert (~clear).sum() <= FEW * n, f"{(~clear).sum()} of {n} rows near a class tie"
    assert (~same).sum() <= FEW * n, f"{(~same).sum()} of {n} rows with another payload"
    return same, clear


def test_compact_forward_matches_jax(runs):
    same, clear = _payload_agreement(runs)
    got, ref = runs["compact"], runs["jcompact"]
    rows = runs["out_rows"]
    assert len(got) == len(ref) == len(rows) > 1000
    np.testing.assert_array_equal(got.xyz, np.asarray(ref.xyz))   # same rows, same order
    np.testing.assert_array_equal(got.rgb, np.asarray(ref.rgb))
    cls, jcls = got.class_l[:, 0], np.asarray(ref.class_l)[:, 0]
    np.testing.assert_array_equal(cls[clear[rows]], jcls[clear[rows]])
    exact = same[rows]
    np.testing.assert_array_equal(got.medial_vector[exact], np.asarray(ref.medial_vector)[exact])
    assert np.isfinite(got.medial_vector).all()


def test_culled_forward_matches_jax(runs):
    same, clear = _payload_agreement(runs)
    got, ref = runs["culled"], runs["jculled"]
    rows = runs["out_rows"]
    np.testing.assert_array_equal(got.xyz, np.asarray(ref.xyz))
    cls, jcls = got.class_l[:, 0], np.asarray(ref.class_l)[:, 0]
    np.testing.assert_array_equal(cls[clear[rows]], jcls[clear[rows]])
    mv, jmv = got.medial_vector, np.asarray(ref.medial_vector)
    both = (cls == 0) & (jcls == 0) & same[rows]
    np.testing.assert_array_equal(mv[both], jmv[both])
    assert (mv[cls != 0] == 0).all() and (jmv[jcls != 0] == 0).all()


def test_culled_equals_compact_on_branch_rows(runs):
    a, b = runs["culled"], runs["compact"]
    np.testing.assert_array_equal(a.xyz, b.xyz)
    np.testing.assert_array_equal(a.class_l, b.class_l)
    branch = b.class_l[:, 0] == 0
    assert branch.any()
    if runs["kind"] == "fp16":   # synthetic-r3 predicts both classes on TREE
        assert (~branch).any()
    np.testing.assert_array_equal(a.medial_vector[branch], b.medial_vector[branch])
    np.testing.assert_array_equal(a.medial_vector[~branch], 0.0)
    # what the skeletonizer consumes is the same either way
    np.testing.assert_array_equal(a.filter_by_class([0]).medial_pts,
                                  b.filter_by_class([0]).medial_pts)


def test_link_bytes_are_the_staged_encodings(runs):
    """Bytes over the link in one forward: the cloud's xyz (12 B a point) and
    its kept block ids (24 B a block) go up once for the device tiler, then
    the one batch's slot table (8 B a slot and a row offset per slot and
    one), all of it smaller than the full path's encoding of the same batch;
    the download is the medial count (8 B), the interior rows' int8 class
    and int32 point index and the medial rows' fp16 radius and int8
    direction, each staged to the granularity. Without `medial_classes`
    every interior row is medial, so where the cull leaves rows out
    (synthetic-r3 on TREE) the culled download is smaller; at the default
    granularity both stage to 4096 rows here, so that pair runs again at
    256."""
    vb, moved = runs["vb"], runs["bytes"]
    n = vb.n_valid
    slots = len(np.unique(vb.coords[:n, 0]))
    per_run = 12 * len(_clouds()[0]) + 24 * slots + 8 * (2 * slots + 1)
    assert moved["compact"]["upload"] == moved["culled"]["upload"] == per_run
    full = sum(a.nbytes for a in vb.compressed_xyz_upload()) + vb.valid.nbytes
    assert per_run < full
    cap, n_i = len(vb.coords), len(runs["out_rows"])
    m = int((runs["culled"].class_l[:, 0] == 0).sum())

    def download(moved, medial, g):
        stage_i, stage_m = (tds.stage_rows(n, cap, g) for n in (n_i, m if medial else n_i))
        assert moved["download"] == 8 + stage_i * (1 + 4) + stage_m * (2 + 3)
        return moved["download"]

    assert download(moved["compact"], None, 4096) >= download(moved["culled"], [0], 4096)
    if runs["kind"] == "fp16":
        assert m < n_i
        fine = {}
        for medial in (None, [0]):
            mi = ModelInference(WEIGHTS["fp16"], device="cpu", medial_classes=medial,
                                upload_granularity=256)
            mi.forward(_clouds()[0])
            fine[medial is None] = download(mi.link_bytes, medial, 256)
        assert fine[False] < fine[True]


# ---------------------------------------------------------------- one run, window

@pytest.mark.parametrize("medial", [None, [0]], ids=["compact", "culled"])
def test_forced_overflow_reruns_the_same_mode_and_gives_the_default_result(medial, monkeypatch):
    cloud, _ = _clouds()
    default = ModelInference(WEIGHTS["fp16"], device="cpu", medial_classes=medial)
    # the JAX keyword that made every level overflow there is not taken
    with pytest.raises(TypeError, match="level_capacity_factor"):
        ModelInference(WEIGHTS["fp16"], device="cpu", level_capacity_factor=0.1)
    forced = ModelInference(WEIGHTS["fp16"], device="cpu", medial_classes=medial)
    calls, passes = [], []
    run, unet = forced._run_batch_culled, forced._unet
    monkeypatch.setattr(forced, "_run_batch_culled",
                        lambda vb: calls.append(vb.capacity) or run(vb))
    monkeypatch.setattr(forced, "_unet", lambda x, plan: passes.append(x.capacity)
                        or unet(x, plan))
    monkeypatch.setattr(forced, "_run_batch", lambda *a, **k: pytest.fail("full path"))
    a, b = forced.forward(cloud), default.forward(cloud)
    # exact plans: one run and one UNet pass for the one batch, on the
    # batch's active rows
    (vb,) = tds.BlockTiler(cloud, 0.01, 4.0, 0.4).batches(4, max_capacity=forced.max_batch_capacity)
    assert calls == [vb.capacity] and passes == [vb.key_order()[2]]
    for f in ("xyz", "rgb", "medial_vector", "class_l"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("medial", [None, [0]], ids=["compact", "culled"])
def test_in_flight_window_gives_identical_clouds(medial):
    cloud, _ = _clouds()
    kw = dict(device="cpu", block_size=1.0, buffer_size=0.1, batch_size=1, medial_classes=medial)
    mi = ModelInference(WEIGHTS["fp16"], **kw)
    assert len(list(tds.BlockTiler(cloud, 0.01, 1.0, 0.1).batches(1))) >= 4
    outs = []
    for k in (1, 2):
        mi.max_in_flight = k
        outs.append(mi.forward(cloud))
    for f in ("xyz", "rgb", "medial_vector", "class_l"):
        np.testing.assert_array_equal(getattr(outs[0], f), getattr(outs[1], f), err_msg=f)


def test_forward_sorts_each_batch_once(monkeypatch):
    """The forward tiles each cloud once on the device (core/tiler.py, two
    host reads: `tile_fetches` <= 2) and gathers each batch's sorted rows
    once; the host sorts no keys (no `key_order()`, no `BlockTiler`), and
    the rows come back in the key order with their point indices."""
    cloud, _ = _clouds()
    mi = ModelInference(WEIGHTS["fp16"], device="cpu", block_size=1.0, buffer_size=0.1,
                        batch_size=1)
    n_batches = len(list(tds.BlockTiler(cloud, 0.01, 1.0, 0.1).batches(
        1, max_capacity=mi.max_batch_capacity)))
    assert n_batches >= 4
    tiles, gathers = [], []
    tile_cloud, gather = tiler.tile_cloud, tiler.gather
    monkeypatch.setattr(tiler, "tile_cloud",
                        lambda *a, **k: tiles.append(len(a[0])) or tile_cloud(*a, **k))
    monkeypatch.setattr(tiler, "gather",
                        lambda vb, *a: gathers.append(vb.capacity) or gather(vb, *a))
    monkeypatch.setattr(tds.VoxelBatch, "key_order", lambda vb: pytest.fail("a host key sort"))
    monkeypatch.setattr(tinf, "BlockTiler", lambda *a, **k: pytest.fail("the host tiler"))
    stats = {}
    assert len(mi.forward(cloud, stats=stats)) > 0
    assert tiles == [len(cloud)] and len(gathers) == n_batches
    assert 0 < stats["tile_fetches"] <= 2


def test_device_and_host_medial_counts_must_agree(monkeypatch):
    cloud, _ = _clouds()
    mi = ModelInference(WEIGHTS["fp16"], device="cpu", medial_classes=[0])
    partition = mi._partition

    def off_by_one(*args):
        *culled, n_med = partition(*args)
        return (*culled, n_med + 1)

    monkeypatch.setattr(mi, "_partition", off_by_one)
    with pytest.raises(RuntimeError, match="download cull"):
        mi.forward(cloud)


def test_budget_and_reference_keys():
    """max_in_flight and hbm_budget_bytes size the batches as in JAX;
    model_path and num_workers are accepted and unused."""
    for budget, k in ((12 << 30, 2), (4 << 30, 1), (12 << 30, 4)):
        mi = ModelInference(WEIGHTS["int8"], device="cpu", hbm_budget_bytes=budget,
                            max_in_flight=k, model_path="unused.pt", num_workers=3)
        jmi = jinf.ModelInference(WEIGHTS["int8"], hbm_budget_bytes=budget, max_in_flight=k)
        assert mi.max_batch_capacity == jmi.max_batch_capacity
        assert mi.upload_granularity == jmi.upload_granularity
