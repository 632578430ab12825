"""NTP-like clock synchronization (reference:
include/edyn/networking/util/clock_sync.hpp:19, src impl; Design.md:385-399:
time_req/time_res exchanges, delta averaged over ~5 rounds)."""
from __future__ import annotations

import dataclasses

NUM_ROUNDS = 5


@dataclasses.dataclass
class ClockSync:
    time_delta: float = 0.0       # remote_time ~= local_time + delta
    _pending_id: int = 0
    _send_time: float = 0.0
    _deltas: list = dataclasses.field(default_factory=list)
    count: int = 0

    def make_request(self, now: float):
        from .packets import TimeRequest
        self._pending_id += 1
        self._send_time = now
        return TimeRequest(timestamp=now, id=self._pending_id)

    def process_response(self, resp, now: float) -> bool:
        """Returns True when a full round set completed and delta updated."""
        if resp.id != self._pending_id:
            return False
        rtt = now - self._send_time
        # remote clock at arrival ~= resp.timestamp + rtt/2
        delta = (resp.timestamp + rtt * 0.5) - now
        self._deltas.append(delta)
        if len(self._deltas) >= NUM_ROUNDS:
            self.time_delta = sum(self._deltas) / len(self._deltas)
            self._deltas.clear()
            self.count += 1
            return True
        return False

    def to_local(self, remote_time: float) -> float:
        return remote_time - self.time_delta

    def to_remote(self, local_time: float) -> float:
        return local_time + self.time_delta
