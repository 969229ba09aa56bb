"""Record pipeline: payload sorts and the duplicate expansion, in plain XLA.

Stages the fast path (``ops/fastpath.py``) builds on:

  1. sort splats by depth, field columns riding as sort payloads (N-sized;
     optional, ``RenderConfig.hoist_depth_sort``)
  2. expand duplicates (``expand_records``): record r belongs to splat
     ``searchsorted(cum_incl, r, side="right")``; its fields are a gather,
     whose transpose under autodiff is the per-splat segment-sum of the
     duplicated records' cotangents (SURVEY.md hard part #5)
  3. sort records by (tile, depth), fields as payloads; the compositor
     (``ops/pallas/composite.py``) consumes this sorted layout directly

Backward of the sorts: they un-sort by carrying the source index and
re-sorting the cotangents (a sort is its own transpose engine). Every record
lands in exactly one splat's segment-sum, so gradients of duplicated splats
are exact.
"""

from __future__ import annotations

import functools
import os as _os
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from openglgaussiansplattingrenderer_jax.config import RenderConfig

# record fields: 0 mx  1 my  2 A  3 B  4 C  5 opacity  6 r  7 g  8 b
NUM_FIELDS = 9


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _f0(x):
    return np.zeros(np.shape(x), jax.dtypes.float0)


# ---------------------------------------------------------------------------
# payload sort with re-sort backward
# ---------------------------------------------------------------------------

# "payload": one (2+NUM_FIELDS)-operand lax.sort -- every merge pass moves
#   ~44 B/record. "gather": sort only (key, iota) (8 B/record through the
#   sort), then apply the permutation with one XLA gather per field; the
#   backward applies the inverse permutation the same way (one 2-op sort to
#   invert + per-field gathers). Bit-identical outputs; which is faster on
#   the GPU is not measured yet, so "payload" stays the default.
#
# NOTE: this flag binds at TRACE time -- jit-compiled callers cache the mode
# they were traced under and ignore later flips, and custom_vjp forward /
# backward must trace under the same mode. That is safe (the two modes are
# proven bit-identical by tests/test_sort_library.py), but flip it only at
# module import, before any pipeline function is traced.
SORT_MODE = "payload"

# Backward cotangent precision through the un-sort. The record sort's
# transpose re-sorts 9 f32 cotangent columns at full record capacity.
# "bf16" packs cotangent PAIRS into single u32 operands (bf16x2 bitcast),
# halving the payload operand count (10 -> 6): gradients round to bf16
# (<= 2^-8 relative) before the per-splat segment sum -- well inside Adam's
# tolerance, but NOT bit-equal to the f32 path, so it is opt-in: set
# GS_BWD_SORT=bf16 (or flip this flag before trace). Forward images are
# bit-identical either way -- only cotangents ride packed.
BWD_COT_PACK = _os.environ.get("GS_BWD_SORT", "f32")


def _pack2(a, b):
    """Two f32 cotangent columns -> one u32 (bf16, bf16) packed operand."""
    ah = jax.lax.bitcast_convert_type(
        a.astype(jnp.bfloat16), jnp.uint16).astype(jnp.uint32)
    bh = jax.lax.bitcast_convert_type(
        b.astype(jnp.bfloat16), jnp.uint16).astype(jnp.uint32)
    return ah * jnp.uint32(65536) + bh


def _unpack2(p):
    a = jax.lax.bitcast_convert_type(
        (p // jnp.uint32(65536)).astype(jnp.uint16), jnp.bfloat16)
    b = jax.lax.bitcast_convert_type(
        (p % jnp.uint32(65536)).astype(jnp.uint16), jnp.bfloat16)
    return a.astype(jnp.float32), b.astype(jnp.float32)


def _sort_cotangents(si, g_fields):
    """Un-sort cotangent columns by the recorded source index ``si`` --
    the payload-sort transpose, at ``BWD_COT_PACK`` precision."""
    gs = tuple(g_fields)
    if BWD_COT_PACK != "bf16":
        out = jax.lax.sort((si,) + gs, num_keys=1, is_stable=True)
        return tuple(out[1:])
    npair = len(gs) // 2
    packed = tuple(_pack2(gs[2 * i], gs[2 * i + 1]) for i in range(npair))
    rest = gs[2 * npair:]                       # odd tail stays f32
    out = jax.lax.sort((si,) + packed + rest, num_keys=1, is_stable=True)
    unpacked = []
    for p in out[1:1 + npair]:
        a, b = _unpack2(p)
        unpacked += [a, b]
    return tuple(unpacked) + tuple(out[1 + npair:])


def _permute(fields, perm):
    return tuple(jnp.take(f, perm, axis=0) for f in fields)


@jax.custom_vjp
def sort_with_payload(key, fields: Tuple[jnp.ndarray, ...]):
    """Stable sort by ``key``; returns (sorted_key, source_idx, sorted_fields).

    Differentiable w.r.t. the float field payloads: the backward pass
    re-sorts the cotangents by the recorded source index (no scatter).
    """
    idx = jnp.arange(key.shape[0], dtype=jnp.int32)
    if SORT_MODE == "gather":
        sk, si = jax.lax.sort((key, idx), num_keys=1, is_stable=True)
        return sk, si, _permute(tuple(fields), si)
    out = jax.lax.sort((key, idx) + tuple(fields), num_keys=1, is_stable=True)
    return out[0], out[1], tuple(out[2:])


def _swp_fwd(key, fields):
    sk, si, sf = sort_with_payload(key, fields)
    return (sk, si, sf), (si, jnp.zeros((0,), key.dtype))


def _swp_bwd(res, g):
    si, key_proto = res
    _, _, g_fields = g
    if SORT_MODE == "gather":
        # si is a full permutation (idx = arange), so the cotangent of the
        # forward gather is a gather by the inverse permutation.
        idx = jnp.arange(si.shape[0], dtype=jnp.int32)
        _, inv = jax.lax.sort((si, idx), num_keys=1, is_stable=True)
        unsorted_fields = _permute(tuple(g_fields), inv)
    else:
        unsorted_fields = _sort_cotangents(si, g_fields)
    # The sort order itself carries no gradient (stop-gradient through the
    # key, as in diff-gaussian-rasterization -- SURVEY.md hard part #3).
    if jnp.issubdtype(key_proto.dtype, jnp.floating):
        d_key = jnp.zeros(si.shape, key_proto.dtype)
    else:
        d_key = _f0(si)
    return (d_key, unsorted_fields)


sort_with_payload.defvjp(_swp_fwd, _swp_bwd)


@jax.custom_vjp
def sort_multi_with_payload(keys: Tuple[jnp.ndarray, ...],
                            fields: Tuple[jnp.ndarray, ...]):
    """Stable lexicographic sort by the key tuple; payload semantics and the
    re-sort backward exactly as ``sort_with_payload``. Used by the sharded
    fast path's owner-side (tile, depth) merge of exchanged records."""
    nk = len(keys)
    idx = jnp.arange(keys[0].shape[0], dtype=jnp.int32)
    out = jax.lax.sort(tuple(keys) + (idx,) + tuple(fields), num_keys=nk,
                       is_stable=True)
    return out[0:nk], out[nk], tuple(out[nk + 1:])


def _smp_fwd(keys, fields):
    sk, si, sf = sort_multi_with_payload(keys, fields)
    return (sk, si, sf), (si, tuple(jnp.zeros((0,), k.dtype) for k in keys))


def _smp_bwd(res, g):
    si, key_protos = res
    _, _, g_fields = g
    unsorted_fields = _sort_cotangents(si, g_fields)
    d_keys = tuple(
        jnp.zeros(si.shape, p.dtype) if jnp.issubdtype(p.dtype, jnp.floating)
        else _f0(si) for p in key_protos)
    return (d_keys, unsorted_fields)


sort_multi_with_payload.defvjp(_smp_fwd, _smp_bwd)


# ---------------------------------------------------------------------------
# quantized-payload record sort (the "q16" inference precision mode)
# ---------------------------------------------------------------------------
# The record sort moves its payload operands through every merge pass, so
# its cost grows with the operand count. Inference does not need bit-exact
# f32 fields, so this mode packs the 9 fields into FIVE u32 lanes before the
# sort and unpacks after:
#
#   w0 = mx:24-bit fixed over [-wp, 2*wp)  | opacity[15:8]
#   w1 = my:24-bit fixed over [-hp, 2*hp)  | opacity[7:0]
#   w2 = conic A (f16) << 16 | conic B (f16)
#   w3 = conic C (f16) << 16 | red   (f16)
#   w4 = green   (f16) << 16 | blue  (f16)
#
# Error budget (checked end-to-end by tests/test_q16.py and gated in
# chip_smoke.py against the f32 image): 24-bit means -> <= 1.8e-4 px at 1024 wide
# (a power error ~1e-3 at the steepest alpha slope); f16 conics -> 4.9e-4
# relative, <= ~3e-3 absolute power at the 1/255 cutoff; f16 colours ->
# <= 0.12/255 units; 16-bit opacity -> 1.5e-5. Everything lands well inside
# the reference's own CPU-vs-GPU assert tolerance of 0.01
# (reference ``src/Splats.cpp:783-843``). Means outside [-wp, 2*wp) x
# [-hp, 2*hp) clamp to the range edge (a splat that far off-screen with a
# rect still touching the image is a degenerate giant; the bench gate
# measures the aggregate effect).
#
# INFERENCE ONLY: quantization is not usefully differentiable (round/clamp
# have zero gradient a.e.), so the custom backward raises instead of
# silently returning zero cotangents. Training paths keep the f32 sort.

_Q16_POS_BITS = 24


def _q16_pack(fields, wp: int, hp: int):
    mx, my, A, B, C, op, r, g, b = fields
    m = (1 << _Q16_POS_BITS) - 1

    def fix24(x, lo, hi):
        s = float(m) / (hi - lo)
        return jnp.clip(jnp.round((x - lo) * s), 0.0, float(m)) \
            .astype(jnp.uint32)

    def f16(x):
        return jax.lax.bitcast_convert_type(
            x.astype(jnp.float16), jnp.uint16).astype(jnp.uint32)

    opq = jnp.clip(jnp.round(op * 65535.0), 0.0, 65535.0).astype(jnp.uint32)
    w0 = fix24(mx, -wp, 2.0 * wp) * jnp.uint32(256) + (opq >> 8)
    w1 = fix24(my, -hp, 2.0 * hp) * jnp.uint32(256) + (opq & jnp.uint32(255))
    w2 = f16(A) * jnp.uint32(65536) + f16(B)
    w3 = f16(C) * jnp.uint32(65536) + f16(r)
    w4 = f16(g) * jnp.uint32(65536) + f16(b)
    return (w0, w1, w2, w3, w4)


def _q16_unpack(words, wp: int, hp: int):
    w0, w1, w2, w3, w4 = words
    m = (1 << _Q16_POS_BITS) - 1

    def unfix24(q, lo, hi):
        s = (hi - lo) / float(m)
        return q.astype(jnp.float32) * s + lo

    def unf16(q):
        return jax.lax.bitcast_convert_type(
            q.astype(jnp.uint16), jnp.float16).astype(jnp.float32)

    mx = unfix24(w0 >> 8, -wp, 2.0 * wp)
    my = unfix24(w1 >> 8, -hp, 2.0 * hp)
    op = (((w0 & jnp.uint32(255)) * jnp.uint32(256)
           + (w1 & jnp.uint32(255))).astype(jnp.float32) / 65535.0)
    A, B = unf16(w2 >> 16), unf16(w2 & jnp.uint32(65535))
    C, r = unf16(w3 >> 16), unf16(w3 & jnp.uint32(65535))
    g, b = unf16(w4 >> 16), unf16(w4 & jnp.uint32(65535))
    return (mx, my, A, B, C, op, r, g, b)


# NOTE on guard placement: a custom_vjp whose differentiable path sits
# behind the integer words does NOT guard anything -- JAX prunes the int
# region out of the gradient graph entirely (silent zero grads, no
# error). Guards must span a float-in -> float-out region:
# ``sort_records_q16`` below for the single-chip sort, and
# ``parallel.fast_sharded._q16_route`` for the sharded
# pack -> exchange -> merge pipeline (both raise in their backward).

@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def sort_records_q16(key, fields: Tuple[jnp.ndarray, ...], wp: int, hp: int):
    """Stable single-key record sort with the 9 fields packed to 5 u32
    payload lanes (see the q16 block comment). Returns (sorted_key,
    unpacked sorted fields). ``wp``/``hp`` are the padded image dims (the
    fixed-point position range). Inference-only: differentiating through
    it raises."""
    if len(fields) != NUM_FIELDS:
        raise ValueError(f"q16 sort packs exactly {NUM_FIELDS} fields, "
                         f"got {len(fields)}")
    out = jax.lax.sort((key,) + _q16_pack(fields, wp, hp), num_keys=1,
                       is_stable=True)
    return out[0], _q16_unpack(out[1:], wp, hp)


def _q16_fwd(key, fields, wp, hp):
    return sort_records_q16(key, fields, wp, hp), None


def _q16_bwd(wp, hp, res, g):
    raise NotImplementedError(
        "sort_payload='q16' is an inference-only precision mode: the "
        "quantized record sort has no useful gradient (round/clamp are "
        "flat a.e.). Train with sort_payload='f32'.")


sort_records_q16.defvjp(_q16_fwd, _q16_bwd)




# ---------------------------------------------------------------------------
# duplicate expansion: per-splat columns -> splat-major records
# ---------------------------------------------------------------------------


def _reachable(vals, tx, ty, pw: int, ph: int, alpha_min: float):
    """Ellipse-reachability cull: can this record's Gaussian reach
    ``alpha_min`` anywhere in its tile's pixel rect?

    The reference bins every tile of the splat's 3-sigma AABB
    (``preprocess.glsl``) and lets ``draw.glsl``'s per-pixel alpha cutoff
    reject the pairs. The exact minimum of the PSD conic quadratic q over
    the rect is the min of the two KKT edge candidates (clamped 1-D
    minimizers); if exp(-qmin/2) * op < alpha_min the record contributes
    exactly zero to every pixel of the tile. Output-exact by construction
    (the margin absorbs the f32 rounding between this test and the
    compositor's power); it culls AABB-corner tiles the ellipse misses and
    the op-dependent radius shrink (contribution radius is
    sqrt(2 ln(op/alpha_min)) sigma, not 3 sigma) the reference ignores.
    """
    mx, my, aa, bb, cc, op = vals[0:6]
    x0 = tx.astype(jnp.float32) * float(pw)
    y0 = ty.astype(jnp.float32) * float(ph)
    # nearest-bound clamps (KKT active constraints of the convex q)
    dx0 = jnp.clip(mx, x0, x0 + (pw - 1)) - mx
    dy0 = jnp.clip(my, y0, y0 + (ph - 1)) - my
    ylo = y0 - my
    xlo = x0 - mx
    # edge candidates: fix one coordinate at its bound, minimize the 1-D
    # quadratic in the other, clamped back into the rect
    dys = jnp.clip(-bb * dx0 / jnp.maximum(cc, 1e-12), ylo, ylo + (ph - 1))
    q1 = (aa * dx0 * dx0 + cc * dys * dys) + 2.0 * (bb * dx0 * dys)
    dxs = jnp.clip(-bb * dy0 / jnp.maximum(aa, 1e-12), xlo, xlo + (pw - 1))
    q2 = (aa * dxs * dxs + cc * dy0 * dy0) + 2.0 * (bb * dxs * dy0)
    qmin = jnp.minimum(q1, q2)
    # reachable iff exp(-qmin/2) * op >= alpha_min; the margin keeps the
    # test conservative under f32 formulation rounding
    ln_ratio = (jnp.log(jnp.maximum(op, 1e-30)) - float(np.log(alpha_min)))
    return qmin * 0.49999 <= ln_ratio + 1e-4


def expand_records(cols: Tuple[jnp.ndarray, ...], depth, capacity: int,
                   cfg: RenderConfig, pw: int, ph: int,
                   ) -> Dict[str, jnp.ndarray]:
    """Expand per-splat columns into ``capacity`` splat-major records.

    ``cols``: 13 per-splat columns in splat order -- the 9 record fields,
    then tile_min x, tile_min y, tile_ext x and the duplicate count (as
    float32, the layout the depth sort carries as payloads). ``depth``:
    per-splat sort depth, gathered into the records when not None (no
    gradient: sort keys are stop-gradient). ``pw`` x ``ph``: tile pixel
    size, for the reachability cull.

    Record r belongs to splat s = searchsorted(cum_incl, r, "right"); slot
    j = r - cum_excl[s] walks the splat's tile rectangle row-major. Records
    past the total, and records that cannot reach ``alpha_min`` in their
    tile, get tile id ``num_tiles`` (sorted past every real tile). Returns
    ``fields`` (9-tuple), ``tile`` (int32), ``depth`` (or None), ``total``
    (records kept, <= capacity) and ``total_all`` (records the scene
    needs).
    """
    counts = cols[12].astype(jnp.int32)
    n = counts.shape[0]
    cum_incl = jnp.cumsum(counts)
    total_all = cum_incl[-1]
    total = jnp.minimum(total_all, capacity).astype(jnp.int32)

    r = jnp.arange(capacity, dtype=jnp.int32)
    s = jnp.minimum(jnp.searchsorted(cum_incl, r, side="right"), n - 1)
    j = r - (cum_incl[s] - counts[s])
    ext = jnp.maximum(cols[11][s].astype(jnp.int32), 1)
    q = j // ext
    ty = cols[10][s].astype(jnp.int32) + q
    tx = cols[9][s].astype(jnp.int32) + (j - q * ext)

    valid = r < total
    fields = tuple(jnp.where(valid, f[s], 0.0) for f in cols[:NUM_FIELDS])
    keep = valid & _reachable(fields, tx, ty, pw, ph, cfg.alpha_min)
    tile = jnp.where(keep, ty * cfg.grid_x + tx, cfg.num_tiles)
    rec_depth = None
    if depth is not None:
        rec_depth = jnp.where(valid, jax.lax.stop_gradient(depth)[s], 0.0)
    return {"fields": fields, "tile": tile.astype(jnp.int32),
            "depth": rec_depth, "total": total, "total_all": total_all}
