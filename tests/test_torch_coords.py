"""Port parity: packed keys, sorts, lookups and dedup
(smart_tree_tpu_torch/core/coords.py vs smart_tree_tpu/core/coords.py).

Integer functions, so every comparison is exact. The port holds uint32 key
values in int64; the comparison casts the JAX keys to int64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu.core import coords as jc
from smart_tree_tpu_torch.core import coords as tc

CASES = [
    # (spatial shape, batch, rows, fraction of padding / out-of-range rows)
    ((20, 20, 20), 1, 300, 0.0),
    ((16, 9, 33), 3, 500, 0.2),
    ((481, 481, 481), 4, 2000, 0.1),
]


def _coords(rng, shape, batch, n, bad):
    c = np.concatenate(
        [
            rng.integers(0, batch, size=(n, 1)),
            np.stack([rng.integers(0, s, size=n) for s in shape], axis=1),
        ],
        axis=1,
    ).astype(np.int32)
    # duplicates, so unique_keys has groups to merge
    c[n // 2 : n // 2 + n // 10] = c[: n // 10]
    nbad = int(bad * n)
    c[n - nbad :] = -1  # padding rows
    if nbad:
        c[n - nbad, 1] = shape[0]  # one out-of-range row
    valid = rng.random(n) > 0.05
    return c, valid


def _keys_np(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("shape,batch,n,bad", CASES)
def test_pack_unpack_sort_lookup(shape, batch, n, bad):
    rng = np.random.default_rng(n)
    c, valid = _coords(rng, shape, batch, n, bad)
    jk = jc.pack_coords(jnp.asarray(c), shape, batch, valid=jnp.asarray(valid))
    tk = tc.pack_coords(torch.from_numpy(c), shape, batch, valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(tk.numpy(), _keys_np(jk))
    assert (tk.numpy() == tc.INVALID_KEY).any() == bool((np.asarray(jk) == jc.INVALID_KEY).any())

    np.testing.assert_array_equal(
        tc.unpack_keys(tk, shape, batch).numpy(),
        np.asarray(jc.unpack_keys(jk, shape, batch)),
    )
    js, jo = jc.sort_keys(jk)
    ts, to = tc.sort_keys(tk)
    np.testing.assert_array_equal(ts.numpy(), _keys_np(js))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    # INVALID (padding) sorts after every valid key
    tsn = ts.numpy()
    assert np.all(np.diff(tsn) >= 0) and (tsn[-1] == tc.INVALID_KEY or bad == 0)

    queries = np.concatenate([_keys_np(jk)[::3], rng.integers(0, 2**20, size=50)])
    jl = jc.lookup(js, jnp.asarray(queries.astype(np.uint32)))
    tl = tc.lookup(ts, torch.from_numpy(queries))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("shape,batch,n,bad", CASES)
@pytest.mark.parametrize("cap_frac", [1.0, 0.5])
def test_unique_keys(shape, batch, n, bad, cap_frac):
    """cap_frac 0.5 overflows the capacity: count exceeds it and the
    truncated outputs must still agree entry for entry."""
    rng = np.random.default_rng(n + 1)
    c, valid = _coords(rng, shape, batch, n, bad)
    jk = jc.pack_coords(jnp.asarray(c), shape, batch, valid=jnp.asarray(valid))
    tk = tc.pack_coords(torch.from_numpy(c), shape, batch, valid=torch.from_numpy(valid))
    cap = max(int(n * cap_frac), 1)
    ju, jf, ji, jn = jc.unique_keys(jk, cap)
    tu, tf, ti, tn = tc.unique_keys(tk, cap)
    np.testing.assert_array_equal(tu.numpy(), _keys_np(ju))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tn) == int(jn)
    if cap_frac < 1.0:
        assert int(tn) > cap


def test_key_bits_overflow_raises():
    with pytest.raises(ValueError):
        tc.key_bits((4096, 4096, 4096), 4)
    assert tc.key_bits((481, 481, 481), 4) == jc.key_bits((481, 481, 481), 4)
