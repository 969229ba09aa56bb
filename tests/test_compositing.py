"""Compositing semantics tests.

Key check: the parallel masked-cumsum formulation in ``ops/compositing.py``
reproduces the reference's *sequential* front-to-back blend with the 0.99
early break exactly (draw.glsl:109-134).
"""

import numpy as np
import jax.numpy as jnp

from openglgaussiansplattingrenderer_jax.config import RenderConfig


def _sequential_blend(alphas, colors, saturation=0.99):
    """Literal alphaBlend loop from draw.glsl:59-67,109-134."""
    acc = 0.0
    rgb = np.zeros(3)
    for a, c in zip(alphas, colors):
        blend = a * (1.0 - acc)
        rgb = rgb + c * blend
        acc = acc + blend
        if acc >= saturation:
            break
    return rgb, acc


def _parallel_blend(alphas, colors, saturation=0.99):
    """The masked-cumsum formulation (single pixel, single chunk)."""
    alphas = np.asarray(alphas, np.float64)
    lg = np.log1p(-alphas)
    cum = np.cumsum(lg)
    s_excl = np.exp(cum - lg)  # transmittance before k
    include = s_excl > (1.0 - saturation)
    w = alphas * s_excl * include
    rgb = (np.asarray(colors).T * w).sum(axis=1)
    trans = np.exp(np.sum(lg * include))
    return rgb, 1.0 - trans


def test_parallel_equals_sequential_random(rng):
    for _ in range(200):
        k = rng.integers(1, 60)
        alphas = rng.uniform(0, 0.99, size=k)
        # sprinkle exact zeros (masked splats)
        alphas[rng.random(k) < 0.3] = 0.0
        colors = rng.uniform(0, 255, size=(k, 3))
        rgb_s, acc_s = _sequential_blend(alphas, colors)
        rgb_p, acc_p = _parallel_blend(alphas, colors)
        np.testing.assert_allclose(rgb_p, rgb_s, rtol=1e-10, atol=1e-9)
        np.testing.assert_allclose(acc_p, acc_s, rtol=1e-10, atol=1e-9)


def test_parallel_equals_sequential_saturating():
    """Force the early break in the middle and verify later splats ignored."""
    alphas = [0.9, 0.9, 0.9, 0.5, 0.7]
    colors = np.eye(3, 3)[[0, 1, 2, 0, 1]] * 100.0
    rgb_s, acc_s = _sequential_blend(alphas, colors)
    rgb_p, acc_p = _parallel_blend(alphas, colors)
    np.testing.assert_allclose(rgb_p, rgb_s, rtol=1e-12)
    np.testing.assert_allclose(acc_p, acc_s, rtol=1e-12)
    # the 3rd splat crosses 0.99: acc after it is 1-(0.1)^3 = 0.999
    assert acc_s >= 0.99
    # splats 4 and 5 must contribute nothing
    assert rgb_s[0] == 100.0 * 0.9  # only the first red splat


def test_composite_empty_tiles():
    """No records -> background image with zero alpha."""
    from openglgaussiansplattingrenderer_jax.ops import compositing

    cfg = RenderConfig(background=(0.25, 0.5, 0.75), max_per_tile=64, chunk=32)
    c = 64
    records = {
        "mean2d": jnp.zeros((c, 2)), "conic": jnp.zeros((c, 3)),
        "color": jnp.zeros((c, 3)), "opacity": jnp.zeros((c,)),
    }
    bounds = jnp.zeros(cfg.num_tiles + 1, jnp.int32)
    img, aux = compositing.composite(records, bounds, 64, 64, cfg)
    img = np.asarray(img)
    assert img.shape == (64, 64, 4)
    np.testing.assert_allclose(img[..., 0], 0.25, atol=1e-6)
    np.testing.assert_allclose(img[..., 3], 0.0, atol=1e-6)
