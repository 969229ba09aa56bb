"""Frame/stage timing utilities.

The JAX replacement for the reference's GL timer queries: the per-frame
``GL_TIMESTAMP`` pair printed each loop (``main.cpp:53-54,84-88``) and the
stage wall-clocks in cpuRender (``Splats.cpp:777-781,847,956,1135``).

JAX returns before the device finishes, so every timer ends its interval
with ``jax.block_until_ready`` on the work's result.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import jax
import numpy as np


class FrameTimer:
    """Per-frame ms timer, the analogue of the reference's
    ``glQueryCounter(GL_TIMESTAMP)`` pair (``main.cpp:53-54,84-88``)."""

    def __init__(self):
        self.frames_ms: List[float] = []
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            jax.block_until_ready(result)
        dt = (time.perf_counter() - self._t0) * 1000.0
        self.frames_ms.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.frames_ms:
            return {"frames": 0, "mean_ms": 0.0, "p50_ms": 0.0,
                    "p95_ms": 0.0, "fps": 0.0}
        a = np.asarray(self.frames_ms[1:] or self.frames_ms)  # drop warmup
        return {
            "frames": len(self.frames_ms),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "fps": float(1000.0 / max(a.mean(), 1e-9)),
        }


def time_stages(stages: List[Tuple[str, Callable]], iters: int = 5,
                warmup: int = 1) -> Dict[str, float]:
    """Time named thunks, each interval ended by ``block_until_ready``;
    returns name -> ms."""
    out = {}
    for name, fn in stages:
        for _ in range(warmup):
            jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(iters):
            r = fn()
        jax.block_until_ready(r)
        out[name] = (time.perf_counter() - t0) / iters * 1000.0
    return out
