"""Render performance statistics.

The device analogue of BufferPool.GetStatistics (BufferPool.cs:133-149) plus the
per-quantum timing probe SURVEY.md §5 calls for. The context records wall
time per render call; ``RenderStats`` summarizes throughput (xRT), quantum
timing, and compile counts. For deep kernel analysis use jax.profiler
(`jax.profiler.trace`) around a render call.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import List


@dataclass
class RenderStats:
    """Aggregated statistics over a context's render calls."""

    render_calls: int = 0
    quanta_rendered: int = 0
    frames_rendered: int = 0
    wall_seconds: float = 0.0
    dispatch_seconds: float = 0.0
    transfer_seconds: float = 0.0
    compile_count: int = 0
    program_reuse_count: int = 0
    #: render-thread exceptions survived (realtime contexts record and
    #: continue instead of dying silently; see context.last_render_error)
    render_errors: int = 0
    #: wall composition of the most recent render call: prep_s (drain/compile/
    #: encode/feed staging), dispatch_s (program launches; per-chunk list in
    #: chunk_dispatch_s), copy_start_s, transfer_s (device->host materialize;
    #: per-chunk list in chunk_transfer_s), notify_s (source ended-events).
    last_breakdown: dict = field(default_factory=dict)
    _call_quantum_us: List[float] = field(default_factory=list)

    def record(
        self, frames: int, quanta: int, wall: float, breakdown: dict = None
    ) -> None:
        self.render_calls += 1
        self.frames_rendered += frames
        self.quanta_rendered += quanta
        self.wall_seconds += wall
        if breakdown is not None:
            self.last_breakdown = breakdown
            self.dispatch_seconds += breakdown.get("dispatch_s", 0.0)
            self.transfer_seconds += breakdown.get("transfer_s", 0.0)
        if quanta > 0:
            self._call_quantum_us.append(wall / quanta * 1e6)
            if len(self._call_quantum_us) > 4096:
                del self._call_quantum_us[:2048]

    def record_compile(self) -> None:
        self.compile_count += 1

    def record_program_reuse(self) -> None:
        """A topology change was served from the compiled-program cache."""
        self.program_reuse_count += 1

    @property
    def realtime_factor(self) -> float:
        """Rendered-audio seconds per wall second (xRT) at 48 kHz; use
        ``xrt(sample_rate)`` for other rates."""
        return self.xrt(48000)

    def xrt(self, sample_rate: int) -> float:
        if self.wall_seconds <= 0:
            return 0.0
        return (self.frames_rendered / sample_rate) / self.wall_seconds

    def _percentile(self, q: float) -> float:
        """True percentile over recorded per-call quantum times.

        Each sample is one render call's wall time divided by the quanta it
        produced; a caller that renders one superblock per call (the realtime
        render thread, or bench.py's latency phase) therefore gets honest
        per-step percentiles. NOT a mean: tail latency is visible.
        """
        if not self._call_quantum_us:
            return 0.0
        data = sorted(self._call_quantum_us)
        if len(data) == 1:
            return float(data[0])
        # Nearest-rank with linear interpolation (numpy 'linear' method).
        pos = q * (len(data) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(data) - 1)
        return float(data[lo] + (data[hi] - data[lo]) * (pos - lo))

    def p50_quantum_us(self) -> float:
        return self._percentile(0.5)

    def p99_quantum_us(self) -> float:
        return self._percentile(0.99)

    def max_quantum_us(self) -> float:
        return max(self._call_quantum_us) if self._call_quantum_us else 0.0

    def summary(self, sample_rate: int) -> dict:
        return {
            "render_calls": self.render_calls,
            "quanta_rendered": self.quanta_rendered,
            "frames_rendered": self.frames_rendered,
            "wall_seconds": round(self.wall_seconds, 6),
            "dispatch_seconds": round(self.dispatch_seconds, 6),
            "transfer_seconds": round(self.transfer_seconds, 6),
            "xrt": round(self.xrt(sample_rate), 2),
            "p50_quantum_us": round(self.p50_quantum_us(), 3),
            "p99_quantum_us": round(self.p99_quantum_us(), 3),
            "max_quantum_us": round(self.max_quantum_us(), 3),
            "compile_count": self.compile_count,
            "program_reuse_count": self.program_reuse_count,
        }
