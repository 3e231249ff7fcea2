"""Straggler watchdog of the training loop (port of ``StragglerWatchdog`` in
``repro/distributed/elastic.py``; the elastic coordinator waits with the
fleet, ROADMAP Queue 1 item 11)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time watchdog: a step slower than ``factor`` x the EWMA is
    flagged as a straggler and is kept out of the EWMA."""

    factor: float = 3.0
    alpha: float = 0.1
    ewma: Optional[float] = None
    flagged: int = 0

    def observe(self, step_time: float) -> bool:
        if self.ewma is None:
            self.ewma = step_time
            return False
        is_straggler = step_time > self.factor * self.ewma
        if is_straggler:
            self.flagged += 1
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
        return is_straggler
