"""Per-stage timing and profiling (port of ``scl_slam_tpu/utils/timing.py``).

Named accumulating timers with streaming stats and a context manager API,
as in the JAX module. On the card a host clock alone times the launches,
not the work, so a :class:`Timers` given a CUDA device synchronizes it at
both ends of a stage. :func:`device_trace` captures a ``torch.profiler``
trace where the JAX module captures a ``jax.profiler`` one.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass

import torch


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


class Timers:
    """Named accumulating timers (one Timers per pipeline or thread).

    ``device``: a CUDA device whose queued work each stage waits for at
    its start and end (``torch.cuda.synchronize``), so a stage's time
    covers the card's work it launched; ``None`` or a CPU device times the
    host clock alone."""

    def __init__(self, device=None):
        self.stages: dict[str, StageStats] = defaultdict(StageStats)
        device = None if device is None else torch.device(device)
        self._sync = device if device is not None and device.type == "cuda" else None

    @contextlib.contextmanager
    def time(self, name: str):
        if self._sync is not None:
            torch.cuda.synchronize(self._sync)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None:
                torch.cuda.synchronize(self._sync)
            self.stages[name].add(time.perf_counter() - t0)

    def record(self, name: str, dt: float):
        self.stages[name].add(dt)

    def report(self) -> dict[str, dict]:
        return {
            k: {
                "count": v.count,
                "total_s": round(v.total_s, 4),
                "mean_ms": round(v.mean_s * 1e3, 3),
                "min_ms": round(v.min_s * 1e3, 3),
                "max_ms": round(v.max_s * 1e3, 3),
            }
            for k, v in sorted(self.stages.items())
        }

    def pretty(self) -> str:
        lines = [f"{'stage':<28}{'count':>7}{'mean ms':>10}{'total s':>10}"]
        for k, v in sorted(self.stages.items()):
            lines.append(
                f"{k:<28}{v.count:>7}{v.mean_s * 1e3:>10.2f}{v.total_s:>10.2f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the host and, where there is a
    card, its kernels; written to ``<log_dir>/trace.json`` (chrome://tracing
    or Perfetto). Yields the profiler (``key_averages()`` for a table)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
