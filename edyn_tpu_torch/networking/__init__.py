"""Client-server networked physics (counterpart of ``edyn_tpu.networking``;
reference: SURVEY §2.9).

Transport-agnostic: the application supplies send callables and feeds
received packets back in, exactly like the reference (README.md:169)."""
from . import packets
from .client import NetworkClient
from .clock_sync import ClockSync
from .input_history import InputHistory
from .interest import InterestState, entities_in_aabb
from .server import NetworkServer
from .packets import should_send_reliably

__all__ = ["packets", "NetworkClient", "NetworkServer", "ClockSync",
           "InputHistory", "InterestState", "entities_in_aabb",
           "should_send_reliably"]
