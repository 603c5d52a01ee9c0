"""Host-side message bus: the GNU Radio message-port / PMT analog.

Counterpart of ``liquiddsp_tpu/runtime/bus.py``. The reference wires blocks
through GR message ports carrying PMT dicts and typed vectors
(lib/flex_tx_impl.cc:57-64, lib/flex_rx_impl.cc:61-63,
python/cognitive_engine.py:68-70). Inter-stage control and PDU traffic stays
on the host (plain Python, device tensors only inside PDUs); device<->host
crossings happen at batch edges only.

``PDU`` mirrors the PMT cons(meta, payload) pair; ``MessageBus`` provides
named ports with multiple subscribers and synchronous dispatch (the GR
scheduler's msg-queue semantics collapse to direct calls in a single-host
pipeline; queued delivery is available via ``post``/``drain`` for loops).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Any, Callable


@dataclasses.dataclass
class PDU:
    """cons(metadata, payload) analog (pmt::cons at lib/flex_tx_impl.cc:204)."""

    meta: dict
    data: Any


class MessageBus:
    def __init__(self):
        self._subs: dict[str, list[Callable[[Any], None]]] = defaultdict(list)
        self._queue: deque[tuple[str, Any]] = deque()

    def subscribe(self, port: str, handler: Callable[[Any], None]):
        self._subs[port].append(handler)

    def has_subscribers(self, port: str) -> bool:
        """Lets publishers skip building expensive messages (e.g. per-slot
        constellation gathers) nobody will consume."""
        return bool(self._subs.get(port))

    def publish(self, port: str, msg: Any):
        """Synchronous dispatch to all subscribers (message_port_pub analog)."""
        for handler in self._subs[port]:
            handler(msg)

    def post(self, port: str, msg: Any):
        """Queue for deferred delivery (decouples feedback loops)."""
        self._queue.append((port, msg))

    def drain(self, max_messages: int | None = None) -> int:
        n = 0
        while self._queue and (max_messages is None or n < max_messages):
            port, msg = self._queue.popleft()
            self.publish(port, msg)
            n += 1
        return n
