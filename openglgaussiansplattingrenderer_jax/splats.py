"""Scene container and the reference-shaped facade.

``SplatScene`` is the functional parameter container (a pytree). ``Splats``
mirrors the reference's ``Splats`` class API (``include/Splats.h:29-124``):
construct from a PLY path + resolution, then ``gpu_render`` (JAX pipeline),
``cpu_render`` (golden numpy pipeline + PNG dump, like ``Splats::cpuRender``)
and ``display``/``save_image``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

from openglgaussiansplattingrenderer_jax.config import RenderConfig
from openglgaussiansplattingrenderer_jax.io import ply as ply_io
from openglgaussiansplattingrenderer_jax.io import png as png_io
from openglgaussiansplattingrenderer_jax.ops.transforms import build_covariance


@dataclasses.dataclass
class SplatScene:
    """Activated splat parameters (see ``io/ply.py`` for load activations)."""

    means: np.ndarray       # (N, 3)
    scales: np.ndarray      # (N, 3), post-exp
    quats: np.ndarray       # (N, 4) wxyz, normalised
    opacities: np.ndarray   # (N,), post-sigmoid
    colors: np.ndarray      # (N, 3), 0..color_scale
    sh_rest: Optional[np.ndarray] = None  # (N, 45) kept for future use

    @classmethod
    def from_ply(cls, path: str, color_scale: float = 255.0) -> "SplatScene":
        d = ply_io.load_splats(path, color_scale)
        return cls(d["means"], d["scales"], d["quats"], d["opacities"],
                   d["colors"], d.get("sh_rest"))

    @classmethod
    def from_dict(cls, d: Dict[str, np.ndarray]) -> "SplatScene":
        return cls(d["means"], d["scales"], d["quats"], d["opacities"],
                   d["colors"], d.get("sh_rest"))

    def __len__(self) -> int:
        return self.means.shape[0]

    def params(self) -> Dict[str, jnp.ndarray]:
        """Differentiable parameter dict for the render pipeline."""
        out = {
            "means": jnp.asarray(self.means),
            "scales": jnp.asarray(self.scales),
            "quats": jnp.asarray(self.quats),
            "opacities": jnp.asarray(self.opacities),
            "colors": jnp.asarray(self.colors),
        }
        if self.sh_rest is not None and self.sh_rest.shape[-1] > 0:
            out["sh_rest"] = jnp.asarray(self.sh_rest)
        return out

    def covariances(self) -> jnp.ndarray:
        """Packed (N, 6) 3D covariances (ref ``Splats::computeCovarianceMatrices``)."""
        return build_covariance(jnp.asarray(self.scales), jnp.asarray(self.quats))

    def save_ply(self, path: str, color_scale: float = 255.0) -> None:
        ply_io.save_ply(path, self.means, self.quats, self.scales,
                        self.opacities, self.colors, self.sh_rest,
                        color_scale=color_scale)


class Splats:
    """Reference-API facade (``include/Splats.h``): path + resolution in,
    rendered frames out."""

    def __init__(self, file_path: str, width: int, height: int,
                 cfg: Optional[RenderConfig] = None,
                 inference: bool = False):
        """``inference=True`` switches the render config to the q16
        inference precision mode (``sort_payload="q16"`` +
        ``depth_key="packed"``, config.py docs): ~20% faster frames at
        capture scale, image error gated well inside the reference's own
        0.01 CPU-vs-GPU tolerance; rendering only -- gradients through
        the facade then raise. Composes with an explicit ``cfg``."""
        self.cfg = cfg or RenderConfig()
        if inference:
            self.cfg = dataclasses.replace(
                self.cfg, sort_payload="q16", depth_key="packed")
        self.scene = SplatScene.from_ply(file_path, self.cfg.color_scale)
        self.width = int(width)
        self.height = int(height)
        self.num_splats = len(self.scene)
        # Load-time covariance precompute, as the reference does on the CPU
        # once at construction (src/Splats.cpp:22, 414-438).
        self.cov6 = np.asarray(self.scene.covariances())
        self.last_image: Optional[np.ndarray] = None
        self.last_stats: Optional[Dict[str, np.ndarray]] = None
        self._device_params: Optional[Dict[str, jnp.ndarray]] = None

    def _params(self) -> Dict[str, jnp.ndarray]:
        p = self.scene.params()
        p["cov6"] = jnp.asarray(self.cov6)
        return p

    def _cached_params(self) -> Dict[str, jnp.ndarray]:
        """Device-resident copy of the scene parameters, uploaded once.

        ``SplatScene.params()`` converts numpy -> device EVERY call; the
        re-upload (~6 MB at 100k splats) would otherwise ride every
        interactive frame. Call ``invalidate_cache()`` after mutating ``self.scene``.
        """
        if self._device_params is None:
            self._device_params = self.scene.params()
        return self._device_params

    def invalidate_cache(self) -> None:
        self._device_params = None

    def autotune_capacity(self, camera, margin: float = 1.2) -> None:
        """Pin the record capacity to this scene's measured record count
        from ``camera``'s viewpoint (``render.autotune_capacity``).

        Capacity bounds the record sort + expand cost -- the pipeline's
        first-order perf knob -- so interactive use should call this once
        after construction (and again after large viewpoint changes; the
        reference instead reads its duplicate counter back EVERY frame,
        ``src/Splats.cpp:579-583``). Overflow on later frames is reported
        by ``last_stats['overflow']`` and warned about, exactly as with a
        fixed ``dup_capacity_factor``.
        """
        from openglgaussiansplattingrenderer_jax.render import (
            autotune_capacity,
            camera_args,
        )

        a = camera_args(camera)
        self.cfg = autotune_capacity(
            self._params(), a["view"], a["vp"], a["focal_x"], a["focal_y"],
            a["tan_fovx"], a["tan_fovy"], self.width, self.height, self.cfg,
            margin=margin)

    def gpu_render(self, view_matrix, width, height, focal_x, focal_y,
                   tan_fov_x, tan_fov_y, vp_matrix) -> np.ndarray:
        """Device render with the reference ``gpuRender`` signature
        (``src/Splats.cpp:587-597``)."""
        from openglgaussiansplattingrenderer_jax.render import _render_jit

        image, stats = _render_jit(
            self._params(), jnp.asarray(view_matrix), jnp.asarray(vp_matrix),
            jnp.float32(focal_x), jnp.float32(focal_y),
            jnp.float32(tan_fov_x), jnp.float32(tan_fov_y),
            int(width), int(height), self.cfg,
        )
        self.last_image = np.asarray(image)
        self.last_stats = {k: np.asarray(v) for k, v in stats.items()}
        self._warn_on_overflow()
        return self.last_image

    def _warn_on_overflow(self) -> None:
        """Warn when the frame dropped records to fit the static capacity.

        The reference silently clamps its duplicate counter at numSplats
        (``Splats.cpp:579-583``); here an image produced with overflow > 0 is
        incomplete (farthest records dropped), so the facade says so.
        """
        ov = int(self.last_stats.get("overflow", 0)) if self.last_stats else 0
        if ov > 0:
            import warnings

            warnings.warn(
                f"render overflowed record capacity by {ov} records "
                f"(dup_capacity_factor={self.cfg.dup_capacity_factor}); the "
                "image is missing the farthest duplicates -- raise "
                "dup_capacity_factor", RuntimeWarning, stacklevel=3)

    def render_camera(self, camera) -> np.ndarray:
        from openglgaussiansplattingrenderer_jax.render import render_stats

        image, stats = render_stats(self._cached_params(), camera, self.cfg)
        self.last_image = np.asarray(image)
        self.last_stats = {k: np.asarray(v) for k, v in stats.items()}
        self._warn_on_overflow()
        return self.last_image

    def render_camera_u8(self, camera, fetch_stats: bool = True
                         ) -> np.ndarray:
        """(H, W, 3) uint8 render for streaming. Two transfer
        optimizations over ``render_camera`` (device->host round trips, not
        only the render, bound streamed fps): quantization (clip + *255 + round,
        the reference saveImage's formula) happens ON DEVICE so the image
        fetch moves 1/5 of the f32 RGBA bytes, and ``fetch_stats=False``
        skips the ~11 scalar stat fetches (each one a full round trip)
        entirely -- stream loops refresh stats every Nth frame instead."""
        import jax.numpy as jnp

        from openglgaussiansplattingrenderer_jax.render import render_stats

        import jax

        image, stats = render_stats(self._cached_params(), camera, self.cfg)
        u8 = (jnp.clip(image[..., :3], 0.0, 1.0) * 255.0 + 0.5
              ).astype(jnp.uint8)
        if fetch_stats:
            # ONE batched device_get -- per-array np.asarray fetches each
            # pay a full device->host round trip
            self.last_stats = jax.device_get(stats)
            self._warn_on_overflow()
        return np.asarray(u8)

    def render_depth_camera(self, camera, mode: str = "ndc",
                            normalize: bool = True):
        """Expected-depth + coverage maps from a Camera (capability beyond
        the reference; see ``render.render_depth``). Returns (depth, alpha)
        as numpy (H, W) arrays."""
        from openglgaussiansplattingrenderer_jax.render import (
            camera_args, render_depth,
        )

        a = camera_args(camera)
        depth, alpha, stats = render_depth(
            self._params(), jnp.asarray(a["view"]), jnp.asarray(a["vp"]),
            a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"],
            camera.width, camera.height, self.cfg, mode=mode,
            normalize=normalize)
        self.last_stats = {k: np.asarray(v) for k, v in stats.items()}
        self._warn_on_overflow()
        return np.asarray(depth), np.asarray(alpha)

    def cpu_render(self, view_matrix, width, height, focal_x, focal_y,
                   tan_fov_x, tan_fov_y, vp_matrix,
                   save_path: Optional[str] = "cpuRender.png") -> np.ndarray:
        """Golden numpy render + PNG dump (ref ``Splats::cpuRender``,
        ``src/Splats.cpp:599-1188``). Does not throw afterwards, unlike the
        reference (:1138)."""
        from openglgaussiansplattingrenderer_jax import golden

        image, _ = golden.golden_render(
            {
                "means": self.scene.means, "cov6": self.cov6,
                "opacities": self.scene.opacities, "colors": self.scene.colors,
            },
            np.asarray(view_matrix), np.asarray(vp_matrix),
            float(focal_x), float(focal_y), float(tan_fov_x), float(tan_fov_y),
            int(width), int(height), self.cfg,
        )
        if save_path:
            png_io.save_png(save_path, image)
        return image

    def display(self, path: str = "render.png") -> None:
        """Headless display path: dump the last rendered frame to PNG
        (the reference's textured-quad present, ``Splats::display``)."""
        if self.last_image is None:
            raise RuntimeError("nothing rendered yet")
        png_io.save_png(path, self.last_image)
