"""Fused tile compositor for the GPU, forward + analytic backward (Pallas on
Triton).

The GPU form of ``draw.glsl``: one program per screen tile walks that tile's
depth-sorted record range ``[bounds[t], bounds[t+1])`` in chunks of
``CHUNK`` records (masked loads straight from the (tile, depth)-sorted
layout, the analogue of the reference's 1024-splat shared-memory batches,
``draw.glsl:94-106``). The tile's pixels are split into blocks of
``block_pixels``; each block keeps its transmittance and rgb in registers
for the tile's lifetime. Blending inside a chunk uses the same parallel
formulation as the jnp compositor (``ops/compositing.py``): transmittance
before record k is ``T * exp(cumsum(log1p(-alpha)) - log1p(-alpha))`` and a
record is included while that exceeds ``1 - saturation``. Early exit:
a pixel block whose pixels are all saturated skips the chunk, and the chunk
loop ends once every block is saturated (``draw.glsl:129-133``'s per-pixel
break at block and chunk granularity; exact, because the include mask
would zero the skipped work anyway).

Backward (a capability the reference lacks): walks the chunks forward again,
recomputing transmittance. The only residual is the kernel's own output
(rgb + final transmittance), from which the suffix colour sum is recovered
as R_total - prefix (the standard 3DGS backward identity, in cumsum form).
Each record belongs to exactly one tile, so each program reduces its
records' cotangents over its own pixels and stores them into the records'
slots: no atomics, deterministic, no dependence on program order. Records
a saturated tile never visits keep the zeros of the aliased output buffer.
The gather that built the records segment-sums duplicated records'
gradients per splat under autodiff (SURVEY.md hard part #5).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.ops.compositing import padded_dims
from openglgaussiansplattingrenderer_jax.utils.platform import pallas_interpret

NUM_FIELDS = 9  # mx, my, A, B, C, opacity, r, g, b

# Kernel shape defaults (picked on the card; PERF.md, "Findings"): records
# per loop step (a power of two), pixels per register-resident block, and
# Triton's launch parameters. The jnp compositor's ``cfg.chunk`` is its own.
CHUNK = 32
BLOCK_PIXELS = 256
NUM_WARPS = 8
NUM_STAGES = 1


def next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def pixel_blocks(pw: int, ph: int, block_pixels: int) -> Tuple[int, int, int]:
    """(p2, pb, nblk): the tile's pixel count padded to a power of two (what
    Triton tensors need), the block size and the number of blocks."""
    p2 = next_pow2(pw * ph)
    pb = min(p2, next_pow2(block_pixels))
    return p2, pb, p2 // pb


def check_chunk(chunk: int) -> None:
    if chunk < 1 or chunk & (chunk - 1):
        raise ValueError(
            f"the compositor streams power-of-two record chunks, got {chunk}")


def _block_pixels(j, pb, pw, p, ox, oy):
    """Pixel-centre coordinates (pb,) of block j and its valid-pixel mask
    (pixels past pw*ph pad the block to a power of two)."""
    i = j * pb + jax.lax.iota(jnp.int32, pb)
    px = ox + (i % pw).astype(jnp.float32)
    py = oy + (i // pw).astype(jnp.float32)
    return px, py, i < p


def _load_chunk(refs, s, chunk, m):
    return [plgpu.load(r.at[pl.ds(s, chunk)], mask=m, other=0.0)
            for r in refs]


def _alpha(px, py, rec, m, alpha_min, alpha_max):
    """(pb, chunk) alpha exactly as ``ops/compositing.composite_ranges``
    computes it (draw.glsl:115-126). Also returns the pieces the backward
    needs."""
    mx, my, ca, cb, cc, op = rec[0:6]
    dx = px[:, None] - mx[None, :]
    dy = py[:, None] - my[None, :]
    power = (-0.5 * (ca[None, :] * dx * dx + cc[None, :] * dy * dy)
             - cb[None, :] * dx * dy)
    ex = jnp.exp(power)
    a_pre = ex * op[None, :]
    alpha = jnp.minimum(alpha_max, a_pre)
    keep = m[None, :] & (power <= 0.0) & (alpha >= alpha_min)
    return jnp.where(keep, alpha, 0.0), keep, dx, dy, ex, a_pre


def _transmittance(trans, alpha, thresh):
    """Per record: log1p(-alpha), transmittance before it, include mask."""
    lg = jnp.log1p(-alpha)
    cum = jnp.cumsum(lg, axis=1)
    s_excl = trans[:, None] * jnp.exp(cum - lg)
    return lg, s_excl, s_excl > thresh


def _carry(trans, lg, inc):
    return trans * jnp.exp(jnp.sum(jnp.where(inc, lg, 0.0), axis=1))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _fwd_kernel(bnd_ref, ox_ref, oy_ref, *refs, chunk, pw, p, pb, nblk,
                alpha_min, alpha_max, thresh):
    rec_refs, out_ref = refs[:NUM_FIELDS], refs[NUM_FIELDS]
    t = pl.program_id(0)
    b0 = bnd_ref[t]
    b1 = bnd_ref[t + 1]
    ox = ox_ref[t].astype(jnp.float32)
    oy = oy_ref[t].astype(jnp.float32)
    nch = (b1 - b0 + chunk - 1) // chunk
    lane = jax.lax.iota(jnp.int32, chunk)
    pix = [_block_pixels(j, pb, pw, p, ox, oy) for j in range(nblk)]
    zero = jnp.zeros((pb,), jnp.float32)
    # padding pixels start saturated: they never blend and never hold the
    # early exit open
    init = tuple((jnp.where(valid, 1.0, 0.0), zero, zero, zero)
                 for _, _, valid in pix)

    def alive(blocks):
        live = jnp.max(blocks[0][0])
        for st in blocks[1:]:
            live = jnp.maximum(live, jnp.max(st[0]))
        return live > thresh

    def cond(carry):
        c, blocks = carry
        return (c < nch) & alive(blocks)

    def body(carry):
        c, blocks = carry
        s = b0 + c * chunk
        m = s + lane < b1
        rec = _load_chunk(rec_refs, s, chunk, m)
        out = []
        for (px, py, _), st in zip(pix, blocks):
            def blend(st, px=px, py=py):
                trans, r, g, b = st
                alpha, _, _, _, _, _ = _alpha(px, py, rec, m, alpha_min,
                                              alpha_max)
                lg, s_excl, inc = _transmittance(trans, alpha, thresh)
                w = jnp.where(inc, alpha * s_excl, 0.0)
                return (_carry(trans, lg, inc),
                        r + jnp.sum(w * rec[6][None, :], axis=1),
                        g + jnp.sum(w * rec[7][None, :], axis=1),
                        b + jnp.sum(w * rec[8][None, :], axis=1))

            out.append(jax.lax.cond(jnp.max(st[0]) > thresh, blend,
                                    lambda st: st, st))
        return c + 1, tuple(out)

    _, blocks = jax.lax.while_loop(cond, body, (jnp.int32(0), init))
    for j, (trans, r, g, b) in enumerate(blocks):
        cols = pl.ds(j * pb, pb)
        out_ref[0, cols] = r
        out_ref[1, cols] = g
        out_ref[2, cols] = b
        out_ref[3, cols] = trans


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def _bwd_kernel(bnd_ref, ox_ref, oy_ref, *refs, chunk, pw, p, pb, nblk,
                alpha_min, alpha_max, thresh):
    """Forward-walk backward pass for one tile.

    Per pixel block: running transmittance and D, the pixel-wise dot of
    g_rgb with the *remaining* (suffix) colour sum, initialised to
    g . R_total and decremented chunk by chunk.
    """
    nf = NUM_FIELDS
    rec_refs = refs[:nf]
    res_ref, g_ref = refs[nf], refs[nf + 1]
    drec_refs = refs[2 * nf + 2:]        # refs[nf+2 : 2nf+2]: aliased zeros
    t = pl.program_id(0)
    b0 = bnd_ref[t]
    b1 = bnd_ref[t + 1]
    ox = ox_ref[t].astype(jnp.float32)
    oy = oy_ref[t].astype(jnp.float32)
    nch = (b1 - b0 + chunk - 1) // chunk
    lane = jax.lax.iota(jnp.int32, chunk)

    consts, init = [], []
    for j in range(nblk):
        px, py, valid = _block_pixels(j, pb, pw, p, ox, oy)
        cols = pl.ds(j * pb, pb)
        gr, gg, gb, gt = (g_ref[k, cols] for k in range(4))
        rr, rg, rb, tfin = (res_ref[k, cols] for k in range(4))
        consts.append((px, py, gr, gg, gb, gt * tfin))
        init.append((jnp.where(valid, 1.0, 0.0), gr * rr + gg * rg + gb * rb))
    init = tuple(init)

    def alive(blocks):
        live = jnp.max(blocks[0][0])
        for st in blocks[1:]:
            live = jnp.maximum(live, jnp.max(st[0]))
        return live > thresh

    def cond(carry):
        c, blocks = carry
        return (c < nch) & alive(blocks)

    def body(carry):
        c, blocks = carry
        s = b0 + c * chunk
        m = s + lane < b1
        rec = _load_chunk(rec_refs, s, chunk, m)
        zeros = tuple(jnp.zeros((chunk,), jnp.float32) for _ in range(nf))
        acc = zeros
        out = []
        for (px, py, gr, gg, gb, gtt), st in zip(consts, blocks):
            def grads(st, px=px, py=py, gr=gr, gg=gg, gb=gb, gtt=gtt):
                trans, d_carry = st
                alpha, keep, dx, dy, ex, a_pre = _alpha(
                    px, py, rec, m, alpha_min, alpha_max)
                lg, s_excl, inc = _transmittance(trans, alpha, thresh)
                w = jnp.where(inc, alpha * s_excl, 0.0)
                # e_k = g_rgb . colour_k ; v = inclusive prefix of w*e
                e = (gr[:, None] * rec[6][None, :] + gg[:, None] * rec[7][None, :]
                     + gb[:, None] * rec[8][None, :])
                we = w * e
                v = jnp.cumsum(we, axis=1)
                abar = jnp.where(inc, alpha, 0.0)
                # dL/dalpha_k = e_k T_k - (suffix colour + transmittance
                # terms) / (1 - alpha_k); zero where the clamp or a mask
                # holds alpha constant
                dabar = (e * s_excl
                         - (d_carry[:, None] - v + gtt[:, None]) / (1.0 - abar))
                gate = keep & inc & (a_pre < alpha_max)
                dalpha = jnp.where(gate, dabar, 0.0)
                d_op = dalpha * ex
                dpow = d_op * rec[5][None, :]
                sums = (
                    jnp.sum(dpow * dx, axis=0), jnp.sum(dpow * dy, axis=0),
                    jnp.sum(dpow * dx * dx, axis=0),
                    jnp.sum(dpow * dx * dy, axis=0),
                    jnp.sum(dpow * dy * dy, axis=0),
                    jnp.sum(d_op, axis=0),
                    jnp.sum(w * gr[:, None], axis=0),
                    jnp.sum(w * gg[:, None], axis=0),
                    jnp.sum(w * gb[:, None], axis=0),
                )
                new = (_carry(trans, lg, inc), d_carry - jnp.sum(we, axis=1))
                return new, sums

            st, sums = jax.lax.cond(jnp.max(st[0]) > thresh, grads,
                                    lambda st: (st, zeros), st)
            acc = tuple(a + b for a, b in zip(acc, sums))
            out.append(st)

        s_dx, s_dy, s_xx, s_xy, s_yy, s_op, s_r, s_g, s_b = acc
        ca, cb, cc = rec[2], rec[3], rec[4]
        # power = -(A dx^2 + C dy^2)/2 - B dx dy with dx = px - mx
        d = (ca * s_dx + cb * s_dy, cc * s_dy + cb * s_dx,
             -0.5 * s_xx, -s_xy, -0.5 * s_yy, s_op, s_r, s_g, s_b)
        for ref, val in zip(drec_refs, d):
            plgpu.store(ref.at[pl.ds(s, chunk)], val, mask=m)
        return c + 1, tuple(out)

    jax.lax.while_loop(cond, body, (jnp.int32(0), init))


# ---------------------------------------------------------------------------
# pallas_call wrappers + custom_vjp
# ---------------------------------------------------------------------------


def _params(num_warps, num_stages):
    return plgpu.CompilerParams(num_warps=num_warps, num_stages=num_stages)


@functools.lru_cache(maxsize=64)
def make_composite_op(num_tiles: int, pw: int, ph: int,
                      alpha_min: float, alpha_max: float, thresh: float,
                      chunk: int = CHUNK,
                      block_pixels: int = BLOCK_PIXELS,
                      num_warps: int = NUM_WARPS,
                      num_stages: int = NUM_STAGES):
    """Fused compositor over (tile, depth)-sorted records.

    op(fields (9 x (C_pad,)), bounds (T+1,), ox (T,), oy (T,)) -> (T, 4, p2)
    [rgb in colour-scale units, transmittance] per tile pixel; pixels at or
    past pw*ph are padding. Each field array must extend at least ``chunk``
    entries past ``bounds[-1]`` (the chunk loads stay in bounds).
    """
    check_chunk(chunk)
    p = pw * ph
    p2, pb, nblk = pixel_blocks(pw, ph, block_pixels)
    static = dict(chunk=chunk, pw=pw, p=p, pb=pb, nblk=nblk,
                  alpha_min=alpha_min, alpha_max=alpha_max, thresh=thresh)
    tile_block = pl.BlockSpec((None, 4, p2), lambda t: (t, 0, 0))
    out_tile = jax.ShapeDtypeStruct((num_tiles, 4, p2), jnp.float32)
    whole = pl.no_block_spec

    def fwd_call(fields, bounds, ox, oy):
        return pl.pallas_call(
            functools.partial(_fwd_kernel, **static),
            grid=(num_tiles,),
            in_specs=[whole] * (3 + NUM_FIELDS),
            out_specs=tile_block,
            out_shape=out_tile,
            backend="triton",
            compiler_params=_params(num_warps, num_stages),
            interpret=pallas_interpret(),
            name="composite_fwd",
        )(bounds, ox, oy, *fields)

    def bwd_call(fields, bounds, ox, oy, out, g):
        c_pad = fields[0].shape[0]
        zeros = [jnp.zeros((c_pad,), jnp.float32) for _ in range(NUM_FIELDS)]
        n_in = 3 + NUM_FIELDS + 2
        return pl.pallas_call(
            functools.partial(_bwd_kernel, **static),
            grid=(num_tiles,),
            in_specs=([whole] * (3 + NUM_FIELDS) + [tile_block] * 2
                      + [whole] * NUM_FIELDS),
            out_specs=[whole] * NUM_FIELDS,
            out_shape=[jax.ShapeDtypeStruct((c_pad,), jnp.float32)]
            * NUM_FIELDS,
            # unvisited (saturation-skipped or unbinned) records keep zeros
            input_output_aliases={n_in + i: i for i in range(NUM_FIELDS)},
            backend="triton",
            compiler_params=_params(num_warps, num_stages),
            interpret=pallas_interpret(),
            name="composite_bwd",
        )(bounds, ox, oy, *fields, out, g, *zeros)

    @jax.custom_vjp
    def op(fields, bounds, ox, oy):
        return fwd_call(fields, bounds, ox, oy)

    def fwd(fields, bounds, ox, oy):
        out = fwd_call(fields, bounds, ox, oy)
        return out, (fields, bounds, ox, oy, out)

    def bwd(res, g):
        fields, bounds, ox, oy, out = res
        d = bwd_call(fields, bounds, ox, oy, out, g)
        f0 = jax.dtypes.float0
        return (tuple(d), np.zeros(bounds.shape, f0),
                np.zeros(ox.shape, f0), np.zeros(oy.shape, f0))

    op.defvjp(fwd, bwd)
    return op


def tile_origins(tile_ids, pw: int, ph: int, gx: int):
    """Per-tile pixel origins (ox, oy) int32 arrays for a set of global tile
    ids, so a sharded device can composite any subset of tiles."""
    tile_ids = jnp.asarray(tile_ids, jnp.int32)
    return (tile_ids % gx) * pw, (tile_ids // gx) * ph


def composite_tiles(fields: Sequence[jnp.ndarray], bounds: jnp.ndarray,
                    tile_ids: jnp.ndarray, width: int, height: int,
                    cfg: RenderConfig, chunk: int = CHUNK,
                    **kernel) -> jnp.ndarray:
    """Composite (tile, depth)-sorted record fields for the tiles
    ``tile_ids`` (global ids; ``bounds`` has one range per listed tile).

    Returns (len(tile_ids), pw*ph, 4) [rgb in colour-scale units,
    transmittance]. ``chunk`` and ``kernel`` (block_pixels, num_warps,
    num_stages) override the kernel shape.
    """
    wp, hp = padded_dims(width, height, cfg)
    pw, ph = wp // cfg.grid_x, hp // cfg.grid_y
    check_chunk(chunk)
    num_tiles = int(tile_ids.shape[0])
    # pad past the last record so every chunk load stays in bounds
    c = fields[0].shape[0]
    c_pad = c + chunk
    padded = tuple(jnp.pad(f.astype(jnp.float32), (0, c_pad - c))
                   for f in fields)
    ox, oy = tile_origins(tile_ids, pw, ph, cfg.grid_x)
    op = make_composite_op(num_tiles, pw, ph, float(cfg.alpha_min),
                           float(cfg.alpha_max), float(1.0 - cfg.saturation),
                           chunk=chunk, **kernel)
    out = op(padded, bounds.astype(jnp.int32), ox, oy)     # (T, 4, p2)
    return jnp.transpose(out[:, :, :pw * ph], (0, 2, 1))

