"""Depth sorting.

JAX replacement for the reference's reusable GPU radix-sort library
(``src/sort.cpp`` + ``shaders/generateHistograms.glsl`` /
``computePrefixSum.glsl`` / ``scan.glsl``: 8 passes of 4-bit digits over
float keys with an index-indirection buffer, 24 dispatches per frame).

A single ``jax.lax.sort`` compiles to one device sort with no
multi-dispatch choreography, and multi-operand lexicographic sort lets us keep
(tile, depth) as separate keys -- full float32 depth precision at any tile
count, unlike the reference's packed ``tileIndex + ndc_z`` float key
(``preprocess.glsl:154``) whose precision degrades as tileIndex grows.

``sort_by_float_key`` reproduces the reference's packed-float-key behaviour for
parity testing. Both paths are *indirect* sorts like the reference's: values
ride along, keys are never rematerialized through gathers.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def sort_by_tile_depth(
    tile: jnp.ndarray, depth: jnp.ndarray, values: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Lexicographic (tile, depth) sort; returns (sorted_tile, sorted_values)."""
    sorted_tile, _, sorted_vals = jax.lax.sort(
        (tile, depth, values), num_keys=2, is_stable=True
    )
    return sorted_tile, sorted_vals


def sort_by_float_key(
    tile: jnp.ndarray, depth: jnp.ndarray, values: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Reference-parity sort on the packed float key tile + depth.

    Ref ``shaders/preprocess.glsl:154``: integer part = tile index, fractional
    part = ndc z. Invalid records carry +inf depth and sort to the end.
    """
    key = tile.astype(jnp.float32) + depth
    sorted_key, sorted_vals = jax.lax.sort((key, values), num_keys=1, is_stable=True)
    sorted_tile = jnp.where(
        jnp.isfinite(sorted_key),
        jnp.floor(sorted_key).astype(jnp.int32),
        jnp.int32(2 ** 30),
    )
    return sorted_tile, sorted_vals


def argsort_floats(keys: jnp.ndarray) -> jnp.ndarray:
    """Stable argsort of float keys -- the contract ``tests/sortTests.cpp``
    checks for the reference sort library (exact agreement with std::sort)."""
    idx = jnp.arange(keys.shape[0], dtype=jnp.int32)
    _, sorted_idx = jax.lax.sort((keys, idx), num_keys=1, is_stable=True)
    return sorted_idx
