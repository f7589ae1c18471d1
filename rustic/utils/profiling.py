"""Profiling & throughput metrics.

The reference's observability is a sample counter and debug prints
(SURVEY.md §5); here we provide ray/path throughput counters, stage
timers, and optional JAX profiler traces (xplane) for device analysis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional


@dataclasses.dataclass
class RenderStats:
    """Throughput accounting for one render."""

    width: int = 0
    height: int = 0
    samples: int = 0
    max_bounces: int = 0
    nee: bool = False
    wall_s: float = 0.0

    @property
    def camera_paths(self) -> int:
        return self.width * self.height * self.samples

    @property
    def mpaths_per_s(self) -> float:
        return self.camera_paths / max(self.wall_s, 1e-9) / 1e6

    @property
    def est_rays(self) -> int:
        """Upper-bound ray count: every path traces up to max_bounces
        nearest rays plus one shadow ray per NEE-eligible bounce."""
        per_path = self.max_bounces * (2 if self.nee else 1)
        return self.camera_paths * per_path

    @property
    def est_mrays_per_s(self) -> float:
        return self.est_rays / max(self.wall_s, 1e-9) / 1e6

    @property
    def spp_per_s(self) -> float:
        return self.samples / max(self.wall_s, 1e-9)

    def summary(self) -> str:
        return (
            f"{self.width}x{self.height}@{self.samples}spp in {self.wall_s:.2f}s: "
            f"{self.mpaths_per_s:.1f} Mpaths/s "
            f"(<= {self.est_mrays_per_s:.0f} Mrays/s), {self.spp_per_s:.1f} spp/s"
        )


class StageTimers:
    """Named wall-clock accumulators (host-side; device work must be
    block_until_ready'd by the caller for accurate numbers)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total * 1e3:.1f} ms total / {n} calls")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """JAX profiler trace (view with tensorboard/xprof). No-op when
    log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
