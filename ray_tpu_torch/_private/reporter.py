"""Per-node metrics + on-demand worker stack dumps.

Reference: ``dashboard/modules/reporter/reporter_agent.py`` (per-node
psutil stats shipped to the dashboard) and ``profile_manager.py:61-97``
(on-demand py-spy stack dumps of stuck workers). TPU-first shape, no agent
daemon:

* node stats are read straight from ``/proc`` (cpu/mem/disk — psutil-free)
  by the head for its host and by each node agent for theirs, shipped on
  the existing control conns and served from the head's node table;
* stack dumps use ``faulthandler.register(SIGUSR1)``: every worker arms a
  C-level signal handler at startup that writes ALL thread stacks to a
  per-pid file — it fires even when the GIL is held or the interpreter is
  wedged mid-syscall, which is exactly the py-spy property that matters
  for debugging a stuck worker (a cooperative RPC would just hang with
  it). The head signals its local workers directly; agents signal theirs.
"""

from __future__ import annotations

import os
import signal
import tempfile
import time
from typing import Optional

#: where workers dump their stacks on SIGUSR1 (under ``$TMPDIR``)
STACKS_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_stacks")


# -- worker side -------------------------------------------------------------


def arm_stack_dumps() -> Optional[str]:
    """Arm SIGUSR1 → all-thread stack dump into this process's stack file.
    Called once at worker startup; safe to call anywhere."""
    import atexit
    import faulthandler

    try:
        os.makedirs(STACKS_DIR, exist_ok=True)
        path = os.path.join(STACKS_DIR, f"{os.getpid()}.stacks")
        f = open(path, "w")  # held open for the process lifetime (signal-safe fd)
        try:
            faulthandler.register(signal.SIGUSR1, file=f, all_threads=True)
        except BaseException:
            f.close()  # a failed arm must not leak the fd (RL016)
            raise
        atexit.register(_unlink_quiet, path)  # crash-killed workers are
        # reaped by their spawner (head death path / agent proc sweep)
        return path
    except (OSError, ValueError, AttributeError):
        return None  # non-posix / restricted env: dumps unavailable


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def reap_stack_file(pid: int) -> None:
    """Spawner-side cleanup for a dead worker's stack file."""
    _unlink_quiet(os.path.join(STACKS_DIR, f"{pid}.stacks"))


def dump_pids(pids: list[int], timeout: float = 2.0) -> dict[int, str]:
    """Signal each pid and collect its stack file (LAST dump). Used by the
    head for local workers and by node agents for theirs."""
    marks: dict[int, Optional[int]] = {}
    out: dict[int, str] = {}
    for pid in pids:
        path = os.path.join(STACKS_DIR, f"{pid}.stacks")
        if not os.path.exists(path):
            # NEVER signal a process that has not armed the handler: the
            # default SIGUSR1 disposition TERMINATES it (a worker still
            # importing, or a restricted env where arming failed)
            out[pid] = "<stack handler not armed>"
            marks[pid] = None
            continue
        marks[pid] = os.path.getsize(path)
        try:
            os.kill(pid, signal.SIGUSR1)
        except (OSError, ProcessLookupError):
            out[pid] = "<process gone>"
            marks[pid] = None
    deadline = time.monotonic() + timeout
    pending = {p for p, m in marks.items() if m is not None}
    last_size = {p: marks[p] for p in pending}
    while pending and time.monotonic() < deadline:
        for pid in list(pending):
            path = os.path.join(STACKS_DIR, f"{pid}.stacks")
            try:
                size = os.path.getsize(path)
            except OSError:
                pending.discard(pid)
                continue
            # the handler writes the dump as many small writes: only read
            # once the size has grown AND been stable for one poll, or a
            # loaded host returns a dump missing its later threads
            if size > marks[pid] and size == last_size[pid]:
                with open(path) as f:
                    f.seek(marks[pid])
                    out[pid] = f.read()
                pending.discard(pid)
            last_size[pid] = size
        if pending:
            time.sleep(0.05)
    for pid in pending:
        out.setdefault(pid, "<no dump within timeout>")
    return out


# -- node stats --------------------------------------------------------------

_last_cpu: Optional[tuple] = None


def node_stats() -> dict:
    """One /proc sample: cpu percent (since the previous call), memory,
    disk of the tmp filesystem, load average."""
    global _last_cpu
    stats: dict = {"time": time.time(), "pid": os.getpid()}
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()[1:8]
        vals = [int(x) for x in parts]
        idle, total = vals[3] + vals[4], sum(vals)
        if _last_cpu is not None:
            didle, dtotal = idle - _last_cpu[0], total - _last_cpu[1]
            stats["cpu_percent"] = round(100.0 * (1 - didle / dtotal), 1) if dtotal else 0.0
        _last_cpu = (idle, total)
    except (OSError, ValueError, ZeroDivisionError):
        pass
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split()[:2]
                info[k.rstrip(":")] = int(v)
        stats["mem_total_kb"] = info.get("MemTotal", 0)
        stats["mem_available_kb"] = info.get("MemAvailable", 0)
        if info.get("MemTotal"):
            stats["mem_percent"] = round(
                100.0 * (1 - info.get("MemAvailable", 0) / info["MemTotal"]), 1
            )
    except (OSError, ValueError):
        pass
    try:
        st = os.statvfs("/tmp")
        stats["disk_free_bytes"] = st.f_bavail * st.f_frsize
        stats["disk_total_bytes"] = st.f_blocks * st.f_frsize
    except OSError:
        pass
    try:
        stats["load_avg_1m"] = os.getloadavg()[0]
    except OSError:
        pass
    return stats


# ---------------------------------------------------------------------------
# on-demand sampling CPU profiler (reference: the dashboard's py-spy
# ``/worker/cpu_profile`` endpoint — dashboard/modules/reporter spawns
# ``py-spy record`` against a worker pid). TPU-native take: no subprocess
# and no ptrace needed — the worker samples ITSELF from a daemon thread via
# sys._current_frames(), emitting Brendan-Gregg collapsed-stack lines that
# flamegraph.pl / speedscope ingest directly. ptrace-free matters in
# containers (CAP_SYS_PTRACE is usually dropped); the trade-off is that a
# fully wedged interpreter can't self-sample — that case is covered by the
# SIGUSR1 faulthandler dumps above, which are C-level.
# ---------------------------------------------------------------------------


def sample_profile(duration_s: float = 2.0, interval_s: float = 0.01) -> str:
    """Sample every thread's Python stack for ``duration_s``; returns
    collapsed-stack text (``frame;frame;frame count`` per line, hottest
    first). Frames render as ``file.py:function``."""
    import sys
    import threading

    counts: dict[str, int] = {}
    me = threading.get_ident()
    end = time.monotonic() + max(0.05, duration_s)
    interval_s = max(0.001, interval_s)
    while time.monotonic() < end:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue  # never profile the profiler
            parts: list[str] = []
            f = frame
            while f is not None:
                code = f.f_code
                parts.append(f"{os.path.basename(code.co_filename)}:{code.co_name}")
                f = f.f_back
            key = ";".join(reversed(parts))
            counts[key] = counts.get(key, 0) + 1
        time.sleep(interval_s)
    lines = [f"{k} {v}" for k, v in sorted(counts.items(), key=lambda kv: -kv[1])]
    return "\n".join(lines)
