"""Reusable sort parity with the reference's GPU radix-sort test.

``tests/sortTests.cpp:127-253`` sorts exactly 5,119,993 random float keys
(32*16*10000 - 7, deliberately not a multiple of the section count) on the
GPU and asserts element-wise equality against std::sort. Same contract here
against np.sort, plus the indirect (argsort) and payload-carrying variants
the renderer uses.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from openglgaussiansplattingrenderer_jax.ops import sorting
from openglgaussiansplattingrenderer_jax.ops import records as rk

N_REFERENCE = 32 * 16 * 10000 - 7  # sortTests.cpp:181


@pytest.mark.slow
def test_sort_five_million_exact(rng):
    # keys in [0.5, 256.5) like the reference generator (utils.cpp:49-63)
    keys = (rng.random(N_REFERENCE, dtype=np.float32) * 256.0 + 0.5).astype(np.float32)
    idx = np.asarray(sorting.argsort_floats(jnp.asarray(keys)))
    got = keys[idx]
    want = np.sort(keys, kind="stable")
    np.testing.assert_array_equal(got, want)
    # orderedness check, as sortTests.cpp:226-242 does separately
    assert np.all(np.diff(got) >= 0)


def test_sort_with_payload_matches_argsort(rng):
    n = 100_000
    keys = rng.random(n).astype(np.float32)
    vals = rng.random(n).astype(np.float32)
    sk, si, (sv,) = rk.sort_with_payload(jnp.asarray(keys), (jnp.asarray(vals),))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(si), order.astype(np.int32))
    np.testing.assert_array_equal(np.asarray(sv), vals[order])
    np.testing.assert_array_equal(np.asarray(sk), keys[order])


def test_sort_gather_mode_matches_payload_mode(rng, monkeypatch):
    """SORT_MODE="gather" (2-op sort + per-field permutation gathers) must be
    bit-identical to the payload sort in both directions of the custom vjp."""
    import jax

    n = 37_113
    keys = rng.integers(0, 2040, n).astype(np.int32)
    fields = tuple(rng.random(n).astype(np.float32) for _ in range(3))

    def run(fields):
        def loss(fields):
            sk, si, sf = rk.sort_with_payload(jnp.asarray(keys), fields)
            return sum(jnp.sum(jnp.cos(f) * jnp.arange(n)) for f in sf), (sk, si, sf)

        (l, out), grads = jax.value_and_grad(loss, has_aux=True)(
            tuple(jnp.asarray(f) for f in fields))
        return l, out, grads

    monkeypatch.setattr(rk, "SORT_MODE", "payload")
    l0, out0, g0 = run(fields)
    monkeypatch.setattr(rk, "SORT_MODE", "gather")
    l1, out1, g1 = run(fields)
    np.testing.assert_array_equal(np.asarray(l0), np.asarray(l1))
    for a, b in zip(jax.tree.leaves((out0, g0)), jax.tree.leaves((out1, g1))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_lexicographic_tile_depth(rng):
    n = 50_000
    tile = rng.integers(0, 256, n).astype(np.int32)
    depth = rng.random(n).astype(np.float32)
    vals = np.arange(n, dtype=np.int32)
    st, sv = sorting.sort_by_tile_depth(jnp.asarray(tile), jnp.asarray(depth),
                                        jnp.asarray(vals))
    order = np.lexsort((depth, tile))
    np.testing.assert_array_equal(np.asarray(st), tile[order])
    np.testing.assert_array_equal(np.asarray(sv), vals[order])


def test_bwd_cotangent_pack_roundtrip(rng):
    """bf16x2 packing is an exact bitcast roundtrip at bf16 precision."""
    a = jnp.asarray(rng.standard_normal(4096).astype(np.float32)) * 1e-3
    b = jnp.asarray(rng.standard_normal(4096).astype(np.float32)) * 1e3
    pa, pb = rk._unpack2(rk._pack2(a, b))
    np.testing.assert_array_equal(
        np.asarray(pa), np.asarray(a.astype(jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_array_equal(
        np.asarray(pb), np.asarray(b.astype(jnp.bfloat16).astype(jnp.float32)))


def test_bwd_bf16_pack_grads_close_to_f32(rng, monkeypatch):
    """GS_BWD_SORT=bf16 rounds the un-sorted cotangents to bf16 -- the
    gradients must match the f32 path to bf16 relative precision and keep
    the same sparsity pattern (zeros stay exactly zero: bf16(0) == 0)."""
    import jax

    n = 20_000
    key = jnp.asarray(rng.integers(0, 512, n).astype(np.int32))
    fields = tuple(jnp.asarray(rng.standard_normal(n).astype(np.float32))
                   for _ in range(9))

    def loss(fields):
        _, _, sf = rk.sort_with_payload(key, fields)
        return sum(jnp.sum(jnp.sin(f) * f) for f in sf)

    monkeypatch.setattr(rk, "BWD_COT_PACK", "f32")
    g32 = jax.grad(loss)(fields)
    monkeypatch.setattr(rk, "BWD_COT_PACK", "bf16")
    g16 = jax.grad(loss)(fields)
    for a, b in zip(g32, g16):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=8e-3, atol=1e-7)
        np.testing.assert_array_equal(np.asarray(a) == 0,
                                      np.asarray(b) == 0)
