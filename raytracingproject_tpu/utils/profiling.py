"""Profiling and observability.

The reference's only perf tooling is the LUNARG_monitor FPS overlay + a
device memory dump (SURVEY.md §5.1). Equivalents here:
- `trace(...)`: jax.profiler trace context writing a TensorBoard-compatible
  profile (xplane) directory.
- `RaysPerSecond`: running rays/s counter (the renderer's "FPS counter").
- `device_memory_stats()`: per-device memory dump
  (graphical_environment_vulkan.cpp:192-206 analog).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/rt_tpu_profile"):
    """Capture a device profile around a block:

        with profiling.trace("/tmp/prof"):
            render(...)  # blocks inside are traced
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@dataclass
class RaysPerSecond:
    """Sliding rays/s meter — the FPS-overlay analog (validation.h:31)."""

    total_rays: int = 0
    total_seconds: float = 0.0
    _t0: float | None = field(default=None, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, rays: int) -> float:
        """Record `rays` traced since start(); returns the interval rays/s."""
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.total_rays += rays
        self.total_seconds += dt
        return rays / dt if dt > 0 else float("inf")

    @property
    def average(self) -> float:
        return self.total_rays / self.total_seconds if self.total_seconds else 0.0


def device_memory_stats() -> list[dict]:
    """Per-device memory stats (dump_device_info analog)."""
    out = []
    for d in jax.devices():
        stats = {}
        try:
            stats = d.memory_stats() or {}
        except Exception:
            pass
        out.append(
            {
                "id": d.id,
                "platform": d.platform,
                "kind": getattr(d, "device_kind", "?"),
                "bytes_in_use": stats.get("bytes_in_use"),
                "bytes_limit": stats.get("bytes_limit"),
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            }
        )
    return out
