"""Host-side training monitor: the straggler detector (port of
`repro/runtime/monitor.py:StragglerDetector`; the serving counters and
the other monitors wait for ROADMAP Queue 1 items 5 and 6)."""
from __future__ import annotations

import collections


class StragglerDetector:
    """EMA of per-host step durations; flags hosts above threshold x
    median (after warmup_steps records, and only with 3 hosts or more)."""

    def __init__(self, hosts: list[int], *, alpha: float = 0.2,
                 threshold: float = 1.5, warmup_steps: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup_steps = warmup_steps
        self._ema = {h: None for h in hosts}
        self._n = collections.Counter()

    def record(self, host: int, duration_s: float):
        prev = self._ema[host]
        self._ema[host] = (duration_s if prev is None
                           else self.alpha * duration_s +
                           (1 - self.alpha) * prev)
        self._n[host] += 1

    def stragglers(self) -> list[int]:
        vals = [(h, e) for h, e in self._ema.items()
                if e is not None and self._n[h] >= self.warmup_steps]
        if len(vals) < 3:
            return []
        ordered = sorted(e for _, e in vals)
        median = ordered[len(ordered) // 2]
        return [h for h, e in vals if e > self.threshold * median]
