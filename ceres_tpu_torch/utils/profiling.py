"""Phase timers (counterpart of ceres_tpu/utils/profiling.py).

`EventLogger` is the reference's scoped phase timer (event_logger.h:66):
each event logs the time since the previous one and since construction.
`ExecutionSummary` and `CallStatistics` keep name -> {calls, time}
(execution_summary.h:45-85), the accounting Solver::Summary harvests.

The clocks are the host's. No timer synchronizes the device: device time
is counted only where the wrapped call waits for its result, which on the
card means a call that ends in a host read (`.item()`, `.cpu()`, a
summary's numbers). Work the call merely enqueues is charged to whatever
waits for it later.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import time
from typing import Dict

logger = logging.getLogger("ceres_tpu_torch")


class EventLogger:
    """Scoped phase timer (event_logger.h): add_event logs the delta since
    the previous event and the total since construction."""

    def __init__(self, name: str, log_level: int = logging.DEBUG):
        self.name = name
        self.start = time.monotonic()
        self.last = self.start
        self.level = log_level
        self.events = []

    def add_event(self, event: str):
        now = time.monotonic()
        delta = now - self.last
        total = now - self.start
        self.last = now
        self.events.append((event, delta, total))
        logger.log(self.level, "%s : %30s : %10.5f : %10.5f", self.name, event, delta, total)


class CallStatistics:
    __slots__ = ("calls", "time")

    def __init__(self):
        self.calls = 0
        self.time = 0.0


class ExecutionSummary:
    """name -> {calls, cumulative time} (execution_summary.h:45)."""

    def __init__(self):
        self.statistics: Dict[str, CallStatistics] = collections.defaultdict(
            CallStatistics)

    @contextlib.contextmanager
    def scoped_timer(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            s = self.statistics[name]
            s.calls += 1
            s.time += time.monotonic() - t0

    def total_time(self, name: str) -> float:
        return self.statistics[name].time

    def num_calls(self, name: str) -> int:
        return self.statistics[name].calls

    def report(self) -> str:
        lines = [f"{'name':40s} {'calls':>8s} {'time':>12s}"]
        for name, s in sorted(self.statistics.items()):
            lines.append(f"{name:40s} {s.calls:8d} {s.time:12.6f}")
        return "\n".join(lines)
