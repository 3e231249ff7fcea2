"""Elastic scaling and straggler mitigation (port of
``repro/distributed/elastic.py``).

On a fleet the coordinator runs beside the router: workers heartbeat to
it, a missed deadline marks the host failed, its work drains to the
survivors, and a recovered heartbeat re-admits it. The control plane is
driven directly here (tests and the fleet router call ``heartbeat`` /
``check``); the decision logic is the reference's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class HostState:
    last_beat: float
    healthy: bool = True


class ElasticCoordinator:
    """Tracks host liveness and proposes mesh reconfigurations.

    A fresh heartbeat from a host marked failed re-admits it: ``heartbeat``
    makes it healthy again and records it for ``drain_recovered``, so the
    router can resume admission. ``mark_failed`` forces the failure without
    waiting out the timeout (deterministic drains and simulated
    outages)."""

    def __init__(self, hosts: List[str], model_axis: int,
                 heartbeat_timeout: float = 60.0, clock=time.monotonic):
        if model_axis < 1:
            raise ValueError(f"model_axis must be >= 1, got {model_axis}")
        self.clock = clock
        self.timeout = heartbeat_timeout
        self.model_axis = model_axis
        self.hosts: Dict[str, HostState] = {
            h: HostState(last_beat=self.clock()) for h in hosts}
        self.generation = 0
        self._recovered: List[str] = []

    def heartbeat(self, host: str) -> None:
        st = self.hosts.get(host)
        if st is None:
            return
        st.last_beat = self.clock()
        if not st.healthy:          # back from the dead: re-admit
            st.healthy = True
            self._recovered.append(host)

    def check(self) -> List[str]:
        """Mark the hosts that missed the deadline -> the newly failed."""
        now = self.clock()
        failed = []
        for name, st in self.hosts.items():
            if st.healthy and now - st.last_beat > self.timeout:
                st.healthy = False
                failed.append(name)
        return failed

    def mark_failed(self, host: str) -> bool:
        """Force-fail a host. Returns whether it was healthy before."""
        st = self.hosts.get(host)
        if st is None or not st.healthy:
            return False
        st.healthy = False
        return True

    def drain_recovered(self) -> List[str]:
        """The hosts that heartbeat back to life since the last call."""
        out, self._recovered = self._recovered, []
        return out

    @property
    def healthy_hosts(self) -> List[str]:
        return [h for h, st in self.hosts.items() if st.healthy]

    def propose_data_axis(self, devices_per_host: int) -> int:
        """The largest power-of-two data-parallel extent the survivors
        support at the fixed model axis; 0 when they cannot fill one model
        group (the run must wait for a re-admission)."""
        if devices_per_host < 1:
            raise ValueError(f"devices_per_host must be >= 1, got "
                             f"{devices_per_host}")
        usable = len(self.healthy_hosts) * devices_per_host // self.model_axis
        if usable < 1:
            return 0
        dp = 1
        while dp * 2 <= usable:
            dp *= 2
        return dp

    def reconfigure(self, devices_per_host: int):
        """-> (new generation id, new data axis extent; 0 means no viable
        mesh over the survivors)."""
        self.generation += 1
        return self.generation, self.propose_data_axis(devices_per_host)


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
