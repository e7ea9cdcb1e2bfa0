"""Tracing / profiling hooks.

The reference's observability is wall-clock prints per phase
(decoder.py:47-676) plus elapsed time in result files (DNA_main.cpp:
1092-1101) and MUSCLE progress bars. The equivalents here:

- ``PhaseTimer`` — structured named-phase wall timings (the pipeline's
  ``phase_times`` dict is built on this);
- ``device_trace`` — context manager around ``jax.profiler`` emitting an
  XPlane trace viewable in TensorBoard/Perfetto;
- ``annotate`` — ``jax.profiler.TraceAnnotation`` wrapper so pipeline
  phases show up inside device traces.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class PhaseTimer:
    times: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{name:>20}: {t:8.3f} s" for name, t in self.times.items()]
        lines.append(f"{'total':>20}: {total:8.3f} s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler device trace for the enclosed block."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """TraceAnnotation context manager (no-op cost when not tracing)."""
    import jax

    return jax.profiler.TraceAnnotation(name)
