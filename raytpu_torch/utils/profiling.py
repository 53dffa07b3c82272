"""Per-frame timing and metric records (counterpart of
raytpu/utils/profiling.py).

The reference's whole instrumentation is a per-frame wall-clock print
("Render time: X ms.", `raytracer.cpp:341-343`). Here:

  * FrameTimer   — the same per-frame timing, with a rays/s counter and
                   aggregate statistics. It reads the host clock, so the
                   timed block must end in a device sync (a ``.item()`` or
                   ``torch.cuda.synchronize()``).
  * log_metrics  — one JSON line per record (step, loss, grad-norm, rays/s)
                   for training loops.

The JAX package's ``trace`` (a device profiler trace) is ROADMAP.md port
item 9.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field


@dataclass
class FrameTimer:
    """Per-frame timer with throughput accounting.

    >>> timer = FrameTimer(rays_per_frame=2 * 512 * 512)
    >>> with timer.frame():
    ...     loss = step().item()  # ends in a device sync
    >>> print(timer.summary())
    """

    rays_per_frame: int = 0
    times_s: list = field(default_factory=list)

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        self.times_s.append(time.perf_counter() - t0)

    @property
    def last_ms(self) -> float:
        return self.times_s[-1] * 1e3 if self.times_s else 0.0

    def mrays_per_s(self, skip_first: bool = True) -> float:
        """Mean throughput, skipping the first frame (kernel builds and
        warm-up)."""
        ts = self.times_s[1:] if skip_first and len(self.times_s) > 1 \
            else self.times_s
        if not ts or not self.rays_per_frame:
            return 0.0
        return self.rays_per_frame / (sum(ts) / len(ts)) / 1e6

    def summary(self) -> str:
        if not self.times_s:
            return "no frames"
        ts = sorted(self.times_s)
        med = ts[len(ts) // 2] * 1e3
        parts = [
            f"{len(self.times_s)} frames",
            f"median {med:.2f} ms",
            f"last {self.last_ms:.2f} ms",
        ]
        if self.rays_per_frame:
            parts.append(f"{self.mrays_per_s():.1f} Mrays/s")
        return ", ".join(parts)


def log_metrics(step: int, stream=None, **metrics) -> None:
    """One JSON line per step: {"step": N, "loss": ..., ...}."""
    rec = {"step": step}
    for k, v in metrics.items():
        try:
            rec[k] = float(v)
        except (TypeError, ValueError):
            rec[k] = str(v)
    print(json.dumps(rec), file=stream or sys.stderr, flush=True)
