"""Per-stage timing + rolling metrics — the framework's observability layer.

Replaces the reference's instrumentation: GPU frame time measured via
`GPUEndTime − GPUStartTime` in a completion handler
(/root/reference/src/metal_renderer.mm:123-129) and the ImGui dashboard's
120-sample rolling FPS/CPU/GPU plots (/root/reference/src/main.mm:86-95,162-182).

Equivalents here:
  * `ScopeTimer` — wall-clock scopes with `jax.block_until_ready` so device
    work is actually attributed to the scope (JAX dispatch is async, the
    analogue of the reference's 3-frames-in-flight pipelining).
  * `RollingStats` — fixed-window mean/min/max histories like the ImGui
    `PlotLines` buffers.
  * `trace` — context manager around `jax.profiler.trace` for TensorBoard
    profiles (the analogue of Metal GPU capture, Info.plist:24-26).
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, Optional

import jax


class RollingStats:
    """Fixed-window rolling statistics (the ImGui 120-frame history pattern,
    main.mm:86-95)."""

    def __init__(self, window: int = 120):
        self.window = window
        self._values: collections.deque = collections.deque(maxlen=window)

    def push(self, value: float) -> None:
        self._values.append(float(value))

    @property
    def mean(self) -> float:
        return sum(self._values) / len(self._values) if self._values else 0.0

    @property
    def last(self) -> float:
        return self._values[-1] if self._values else 0.0

    @property
    def min(self) -> float:
        return min(self._values) if self._values else 0.0

    @property
    def max(self) -> float:
        return max(self._values) if self._values else 0.0

    def __len__(self) -> int:
        return len(self._values)


class ScopeTimer:
    """Named wall-clock scopes with device synchronization.

    Usage:
        timers = ScopeTimer()
        with timers.scope("raster", result):   # blocks on `result` at exit
            result = render(...)
    """

    def __init__(self, window: int = 120):
        self.stats: Dict[str, RollingStats] = {}
        self.window = window

    @contextlib.contextmanager
    def scope(self, name: str, block_on=None):
        start = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            target = holder.get("result", block_on)
            if target is not None:
                jax.block_until_ready(target)
            elapsed_ms = (time.perf_counter() - start) * 1000.0
            self.stats.setdefault(name, RollingStats(self.window)).push(elapsed_ms)

    def summary(self) -> Dict[str, float]:
        return {name: s.mean for name, s in self.stats.items()}

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items()):
            lines.append(
                f"{name:<24} last {s.last:8.3f} ms   mean {s.mean:8.3f} ms   "
                f"min {s.min:8.3f}   max {s.max:8.3f}   (n={len(s)})"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """TensorBoard profiler trace scope (no-op when log_dir is None)."""
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield


def time_fn(fn, *args, warmup: int = 2, iters: int = 10, **kwargs) -> float:
    """Benchmark helper: median wall-clock ms of `fn(*args)` with device sync."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    return times[len(times) // 2]
