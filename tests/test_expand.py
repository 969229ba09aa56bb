"""The fast path's duplicate expansion (``ops/records.expand_records``) vs
the oracle's (``ops/binning.expand_records``), and the reachability cull."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from openglgaussiansplattingrenderer_jax.camera import Camera
from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.ops import binning
from openglgaussiansplattingrenderer_jax.ops import records as rk
from openglgaussiansplattingrenderer_jax.render import camera_args, render_arrays

CFG = RenderConfig(grid_x=16, grid_y=16)


def _splats(rng, n):
    """Per-splat tile rectangles inside the 16x16 grid, some empty."""
    ext = rng.integers(1, 5, size=(n, 2)).astype(np.int32)
    tmin = np.stack([rng.integers(0, 17 - ext[:, 0]),
                     rng.integers(0, 17 - ext[:, 1])], axis=1).astype(np.int32)
    counts = (ext[:, 0] * ext[:, 1]).astype(np.int32)
    counts[rng.random(n) < 0.2] = 0                  # culled splats
    return counts, tmin, ext


def _cols(counts, tmin, ext, fields):
    return tuple(jnp.asarray(f, jnp.float32) for f in fields) + (
        jnp.asarray(tmin[:, 0], jnp.float32), jnp.asarray(tmin[:, 1], jnp.float32),
        jnp.asarray(ext[:, 0], jnp.float32), jnp.asarray(counts, jnp.float32))


@pytest.mark.parametrize("n", [1, 100, 2048, 5000, 70000])
def test_expand_matches_oracle(rng, n):
    counts, tmin, ext = _splats(rng, n)
    counts[0] = max(counts[0], 1)
    capacity = int(counts.sum()) + 64
    # fields: splat index in mx (checks the record -> splat map); zero conic
    # and unit opacity make every record reachable, so the cull keeps all
    sid = np.arange(n, dtype=np.float32)
    zero = np.zeros(n, np.float32)
    one = np.ones(n, np.float32)
    fields = (sid, zero, zero, zero, zero, one, zero, zero, zero)
    got = rk.expand_records(_cols(counts, tmin, ext, fields), None, capacity,
                            CFG, 8, 8)
    want = binning.expand_records(
        jnp.asarray(counts), jnp.asarray(tmin), jnp.asarray(ext),
        jnp.zeros(n, jnp.float32), CFG, capacity)
    assert int(got["total"]) == int(want["total"]) == int(counts.sum())
    np.testing.assert_array_equal(np.asarray(got["tile"]),
                                  np.asarray(want["tile"]))
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(np.asarray(got["fields"][0])[valid],
                                  np.asarray(want["splat_id"])[valid])
    assert not np.asarray(got["fields"][5])[~valid].any()


def test_expand_float_depth_and_overflow(rng):
    """Depth rides along as a float gather; records past the capacity are
    counted in total_all, not kept."""
    n = 3000
    counts, tmin, ext = _splats(rng, n)
    depth = rng.random(n).astype(np.float32)
    capacity = int(counts.sum()) // 2
    fields = tuple(rng.random(n).astype(np.float32) for _ in range(9))
    got = rk.expand_records(_cols(counts, tmin, ext, fields),
                            jnp.asarray(depth), capacity, CFG, 8, 8)
    want = binning.expand_records(
        jnp.asarray(counts), jnp.asarray(tmin), jnp.asarray(ext),
        jnp.asarray(depth), CFG, capacity)
    assert int(got["total_all"]) == int(counts.sum())
    assert int(got["total"]) == capacity
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(np.asarray(got["depth"])[valid],
                                  np.asarray(want["depth"])[valid])
    np.testing.assert_allclose(
        np.asarray(got["fields"][3])[valid],
        fields[3][np.asarray(want["splat_id"])[valid]])


def test_cull_leaves_image_unchanged(monkeypatch):
    """The reachability cull drops records, never pixels: with it disabled
    the fast path renders the same image from more records."""
    w = h = 64
    scene = ply_io.make_synthetic_scene(300, seed=5, extent=2.0)
    cam = Camera(0.0, 0.0, -5.0, width=w, height=h)
    a = camera_args(cam)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    cfg = RenderConfig(chunk=32, dup_capacity_factor=24.0)

    def render():
        return jax.jit(lambda p: render_arrays(
            p, jnp.asarray(a["view"]), jnp.asarray(a["vp"]), a["focal_x"],
            a["focal_y"], a["tan_fovx"], a["tan_fovy"], w, h, cfg))(params)

    img_c, st_c = render()
    monkeypatch.setattr(rk, "_reachable",
                        lambda vals, *args: jnp.ones_like(vals[0], bool))
    img_a, st_a = render()
    assert int(st_c["culled_unreachable"]) > 0
    assert int(st_a["culled_unreachable"]) == 0
    assert int(st_c["binned_records"]) < int(st_a["binned_records"])
    np.testing.assert_allclose(np.asarray(img_c), np.asarray(img_a),
                               atol=1e-6)
