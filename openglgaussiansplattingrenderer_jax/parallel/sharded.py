"""Multi-chip sharded rendering and training (shard_map over a device mesh).

The reference is strictly single-GPU/single-process (SURVEY.md section 2.4);
this layer is the capability the north star adds. Design (round 1):

- **splat-sharded preprocess**: scene parameters are sharded over the mesh
  axis; each chip projects and duplicates its N/D splats into a local
  capacity-padded record array (no cross-chip traffic).
- **record all-gather**: the compact per-record fields (9 floats + key) ride
  an ``all_gather`` -- the analogue of the reference's tile
  duplication being "communication" (SURVEY.md section 5, long-context row).
- **replicated sort, tile-sharded composite**: every chip sorts the gathered
  records by (tile, depth) and composites only its own stripe of tiles; the
  output image is tile-sharded across the mesh.
- **backward**: jax.grad through ``shard_map`` turns the all-gather into a
  reduce-scatter of record gradients back to the owning chip, where the
  gather transpose segment-sums duplicated records per splat -- a splat
  duplicated across tiles on different chips receives the exact sum of its
  contributions (SURVEY.md hard part #5), by construction.

Known round-1 inefficiency, by choice: the per-chip replicated global sort.
A ragged all-to-all by tile ownership (records are already keyed) removes it
and is the planned next step; correctness and gradient identity come first.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map as _shard_map


def shard_map(f, mesh, in_specs, out_specs):
    # check_vma=False: Pallas calls inside the body can't declare their
    # outputs' varying-mesh-axes, so the static replication checker must be
    # off for the fast sharded path (outputs are all P(axis) anyway).
    # jit: an eager caller would otherwise run the body op by op per device.
    return jax.jit(_shard_map(f, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs, check_vma=False))


from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.ops import binning, projection
from openglgaussiansplattingrenderer_jax.ops.compositing import (
    assemble_image,
    composite_ranges,
    tile_pixel_coords,
)
from openglgaussiansplattingrenderer_jax.ops.transforms import build_covariance

AXIS = "dev"


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    return Mesh(np.array(devices[:n]), (axis,))


def pad_scene_for_mesh(params: Dict[str, jnp.ndarray], n_devices: int
                       ) -> Dict[str, jnp.ndarray]:
    """Pad splat count to a multiple of the mesh size with opacity-0 splats."""
    n = params["means"].shape[0]
    pad = (-n) % n_devices
    if pad == 0:
        return params
    out = {}
    for k, v in params.items():
        padding = np.zeros((pad,) + v.shape[1:], v.dtype)
        if k == "quats":
            padding[:, 0] = 1.0
        if k == "scales":
            padding[:] = 1e-6
        if k == "means":
            padding[:] = 1e6  # far outside every frustum
        out[k] = jnp.concatenate([jnp.asarray(v), jnp.asarray(padding)], axis=0)
    return out


def shard_params(params: Dict[str, jnp.ndarray], mesh: Mesh,
                 axis: str = AXIS) -> Dict[str, jnp.ndarray]:
    sharding = NamedSharding(mesh, P(axis))
    return {k: jax.device_put(v, sharding) for k, v in params.items()}


def _shard_fn(params_local, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
              pxs, pys, *, width, height, cfg: RenderConfig, axis: str,
              n_local: int, tiles_per_dev: int):
    """Per-device body run under shard_map."""
    d = jax.lax.axis_index(axis)

    cov6 = build_covariance(params_local["scales"], params_local["quats"])
    prep = projection.preprocess(
        params_local["means"], cov6, params_local["opacities"], view, vp,
        width, height, focal_x, focal_y, tan_fovx, tan_fovy, cfg)
    cap_local = cfg.capacity(n_local)
    recs = binning.expand_records(
        prep["counts"], prep["tile_min"], prep["tile_ext"], prep["depth"],
        cfg, cap_local)

    sid = recs["splat_id"]
    packed = jnp.concatenate(
        [prep["mean2d"][sid], prep["conic"][sid],
         prep["opacity"][sid][:, None], params_local["colors"][sid]], axis=1)
    packed = jnp.where(recs["valid"][:, None], packed, 0.0)     # (capL, 9)

    # all-gather of compact records; transpose = reduce-scatter of grads.
    packed_g = jax.lax.all_gather(packed, axis, axis=0, tiled=True)
    tile_g = jax.lax.all_gather(recs["tile"], axis, axis=0, tiled=True)
    depth_g = jax.lax.all_gather(recs["depth"], axis, axis=0, tiled=True)

    row = jnp.arange(tile_g.shape[0], dtype=jnp.int32)
    tile_s, _, row_s = jax.lax.sort((tile_g, depth_g, row), num_keys=2,
                                    is_stable=True)
    rec_sorted = packed_g[row_s]
    bounds = jnp.searchsorted(
        tile_s, jnp.arange(cfg.num_tiles + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)

    my_tiles = d * tiles_per_dev + jnp.arange(tiles_per_dev, dtype=jnp.int32)
    records = {
        "mean2d": rec_sorted[:, 0:2],
        "conic": rec_sorted[:, 2:5],
        "opacity": rec_sorted[:, 5],
        "color": rec_sorted[:, 6:9],
    }
    rgb, trans = composite_ranges(
        records, bounds[my_tiles], bounds[my_tiles + 1],
        pxs[my_tiles], pys[my_tiles], cfg)
    return rgb, trans


def render_sharded(params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
                   width: int, height: int, cfg: RenderConfig, mesh: Mesh,
                   axis: str = AXIS) -> jnp.ndarray:
    """Multi-chip render: splat-sharded preprocess, tile-sharded composite.

    ``params`` leaves must be shardable on axis 0 by the mesh size (use
    ``pad_scene_for_mesh``). Returns the full (H, W, 4) image.
    """
    ndev = mesh.shape[axis]
    n = params["means"].shape[0]
    if n % ndev:
        raise ValueError(f"{n} splats not divisible by {ndev} devices; "
                         "use pad_scene_for_mesh")
    if cfg.num_tiles % ndev:
        raise ValueError(f"{cfg.num_tiles} tiles not divisible by {ndev} devices")
    pxs, pys = tile_pixel_coords(width, height, cfg)

    fn = shard_map(
        functools.partial(
            _shard_fn, width=width, height=height, cfg=cfg, axis=axis,
            n_local=n // ndev, tiles_per_dev=cfg.num_tiles // ndev),
        mesh=mesh,
        in_specs=(P(axis), P(), P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P(axis), P(axis)),
    )
    rgb, trans = fn(params, jnp.asarray(view), jnp.asarray(vp),
                    jnp.float32(focal_x), jnp.float32(focal_y),
                    jnp.float32(tan_fovx), jnp.float32(tan_fovy), pxs, pys)
    return assemble_image(rgb, trans, width, height, cfg)


def sharded_train_step(raw, opt_state, target, view, vp, focal_x, focal_y,
                       tan_fovx, tan_fovy, *, width: int, height: int,
                       cfg: RenderConfig, mesh: Mesh, optimizer,
                       axis: str = AXIS):
    """One jittable step of fitting splats to a target image on the mesh.

    The full training step the driver's ``dryrun_multichip`` exercises:
    sharded forward, collective-backed backward, optax update on sharded
    parameter pytrees. Like ``train/trainer.py``, optimisation happens in
    *raw* (pre-activation) space -- log-scales, logit-opacities,
    unnormalised quaternions (renormalised inside ``params_from_raw``) --
    so updates can never push activations out of range. ``raw`` is a
    ``trainer.raw_from_params`` pytree sharded over the mesh.
    """
    from openglgaussiansplattingrenderer_jax.train.trainer import params_from_raw

    def loss_fn(raw):
        img = render_sharded(params_from_raw(raw), view, vp, focal_x, focal_y,
                             tan_fovx, tan_fovy, width, height, cfg, mesh, axis)
        return jnp.mean((img[..., :3] - target) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(raw)
    updates, opt_state = optimizer.update(grads, opt_state, raw)
    raw = jax.tree.map(lambda a, u: a + u, raw, updates)
    return raw, opt_state, loss
