"""Throttled daemon-loop warnings (copy of ``ray_tpu/_private/log_util.py``).

Daemon loops (health checks, reconcilers, stats pumps) must survive any
exception, but swallowing them silently turns real outages invisible —
raylint's RL007. This helper is the sanctioned middle ground: always keep
the loop alive, print the first failure per call-site immediately, then
rate-limit repeats so a persistent fault logs once per interval instead of
once per tick.
"""

from __future__ import annotations

import threading
import time

_lock = threading.Lock()
_last_emit: dict[str, float] = {}
_suppressed: dict[str, int] = {}
_MAX_KEYS = 1024  # call sites may key on channel/node names: bound the table


def warn_throttled(key: str, exc: BaseException, interval_s: float = 60.0) -> None:
    """Print ``[ray_tpu] <key>: <exc!r>`` at most once per ``interval_s``
    per ``key``; repeats within the window are counted and reported with the
    next emission so nothing is lost, only batched."""
    now = time.monotonic()
    with _lock:
        last = _last_emit.get(key)
        if last is not None and now - last < interval_s:
            _suppressed[key] = _suppressed.get(key, 0) + 1
            return
        if key not in _last_emit and len(_last_emit) >= _MAX_KEYS:
            oldest = min(_last_emit, key=_last_emit.get)
            del _last_emit[oldest]
            _suppressed.pop(oldest, None)
        _last_emit[key] = now
        n = _suppressed.pop(key, 0)
    suffix = f" ({n} similar suppressed)" if n else ""
    try:
        print(f"[ray_tpu] WARNING: {key}: {exc!r}{suffix}")
    except Exception:
        # stdout may be a closed pipe (parent gone, interpreter teardown).
        # This helper runs inside daemon-loop except handlers whose entire
        # job is keeping the loop alive — it must never raise.
        pass
