"""Cluster pubsub: named channels pushed from the head (copy of
``ray_tpu/util/pubsub.py``).

Counterpart of the reference's pubsub layer (``src/ray/pubsub/`` —
long-poll publisher/subscriber channels carrying GCS actor/job/node
updates). Here the head pushes ``("pub", channel, payload)``
frames down each subscriber's existing control socket (no long-poll
round-trips), and in-process drivers subscribe with a plain callback.

Built-in channels published by the head:

* ``"nodes"`` — ``{"event": "added"|"removed", "node_id": hex, ...}``
* ``"actors"`` — ``{"event": "ALIVE"|"RESTARTING"|"DEAD", "actor_id": hex,
  "name": str|None}``

Any other channel name is application-defined: ``publish(channel, msg)``
fans out to every subscriber in the cluster.
"""

from __future__ import annotations

import queue
from typing import Any, Optional

from ray_tpu_torch._private.runtime import get_ctx


class Subscriber:
    """Iterator/queue view of one channel subscription."""

    def __init__(self, channel: str, maxsize: int = 10_000):
        self.channel = channel
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._closed = False
        get_ctx().pub_register(channel, self._on_msg)

    def _on_msg(self, _channel: str, payload) -> None:
        try:
            self._q.put_nowait(payload)
        except queue.Full:
            pass  # slow subscriber: drop (reference: pubsub buffer caps)

    def get(self, timeout: Optional[float] = None):
        """Next message, or raise ``queue.Empty`` after ``timeout``."""
        return self._q.get(timeout=timeout)

    def poll(self) -> list:
        """Drain everything currently buffered without blocking."""
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                get_ctx().pub_unregister(self.channel, self._on_msg)
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        while not self._closed:
            yield self.get()


def subscribe(channel: str) -> Subscriber:
    return Subscriber(channel)


def publish(channel: str, message: Any) -> None:
    """Deliver ``message`` to every current subscriber of ``channel``."""
    get_ctx().call("publish", channel=channel, payload=message)
