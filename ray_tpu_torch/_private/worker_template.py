"""Forkserver template: per-node warm process that forks workers on demand.

Reference: the raylet's worker pool pre-starts idle language workers so a
lease never pays interpreter boot (``src/ray/raylet/worker_pool.h:152``,
``maximum_startup_concurrency``). The TPU-native build goes one step
further: instead of keeping N warm *idle* processes around, each node keeps
ONE warm template process with the worker module graph already imported,
and every worker (plain or actor) is an ``os.fork()`` of it — ~5-10ms
instead of a ~300ms+ cold ``python -m`` boot, with memory shared
copy-on-write. This is the same design as CPython's own
``multiprocessing.forkserver``, specialised for our worker entrypoint.

Protocol: the spawner (head or node agent) writes one line per spawn
request to this process's stdin — the worker's startup token — and the
template forks a child that becomes a normal worker (connects to the head,
registers with that token). Lines are < PIPE_BUF so concurrent writers
can't interleave. stdin EOF (spawner died) exits the template.

Fork safety: the template stays single-threaded for its whole life (the
import of worker_main starts no threads — asserted below), so a fork can
never inherit a held lock. Children reset SIGCHLD (the template sets
SIG_IGN so the kernel auto-reaps workers; a worker running user code that
uses ``subprocess`` needs default semantics back) and close the command
pipe so only the template ever reads it.
"""

from __future__ import annotations

import os
import signal
import sys


def main(
    socket_path: str,
    authkey_hex: str,
    node_id_hex: str,
    remote: bool,
    report_fd: int = 0,
) -> None:
    # The point of the template: pay the import graph ONCE, before any fork.
    import ray_tpu_torch._private.worker_main as worker_main  # noqa: PLC0415

    # Modules workers otherwise lazy-import at their first task/actor —
    # cold-spawned workers defer these to keep boot light, but a forked
    # worker gets them free via copy-on-write (none start threads, which
    # the active_count() guard below would catch):
    import asyncio  # noqa: F401  (async actor event loops)
    import concurrent.futures  # noqa: F401  (threaded actors / io pools)
    import inspect  # noqa: F401  (actor engine selection)

    import ray_tpu_torch._private.data_plane  # noqa: F401  (remote arg fetches)
    import ray_tpu_torch._private.runtime_env  # noqa: F401  (renv.applied per task)

    # the cluster's ``preload_python_modules`` (config.py): imported once
    # here, shared by every fork
    import importlib

    for name in os.environ.get("RAY_TPU_PRELOAD_PYTHON_MODULES", "").split(","):
        if name.strip():
            try:
                importlib.import_module(name.strip())
            except ImportError as e:
                print(f"[ray_tpu_torch] worker_template: cannot preload {name.strip()}: {e}", file=sys.stderr)

    import threading

    if threading.active_count() != 1:  # pragma: no cover - fork-safety guard
        print(
            "[ray_tpu_torch] worker_template: import started threads; forked workers "
            "may inherit held locks",
            file=sys.stderr,
        )
    signal.signal(signal.SIGCHLD, signal.SIG_IGN)  # kernel reaps forked workers
    authkey = bytes.fromhex(authkey_hex)
    node_id = bytes.fromhex(node_id_hex)
    stdin = sys.stdin.buffer.raw if hasattr(sys.stdin.buffer, "raw") else sys.stdin.buffer
    buf = b""
    while True:
        try:
            chunk = stdin.read(4096)
        except OSError:
            return
        if not chunk:
            return  # spawner closed the pipe: shut down
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            token = line.decode().strip()
            if not token:
                continue
            try:
                pid = os.fork()
            except OSError as e:
                # EAGAIN/ENOMEM under pressure: fail THIS spawn (its
                # registration timeout covers the loss), keep the template
                # alive for the requests still buffered behind it
                print(
                    f"[ray_tpu_torch] worker_template: fork failed: {e}",
                    file=sys.stderr,
                )
                continue
            if pid == 0:
                # -- child: become a worker ---------------------------------
                signal.signal(signal.SIGCHLD, signal.SIG_DFL)
                for fd in (0, report_fd) if report_fd else (0,):
                    try:
                        os.close(fd)  # command + report pipes stay with the
                    except OSError:  # template only
                        pass
                try:
                    worker_main.main(
                        socket_path, authkey, node_id, token, remote=remote
                    )
                except (ConnectionError, EOFError, FileNotFoundError):
                    # cluster died while this worker forked: quiet exit.
                    # Deliberately NOT all OSError — ENOSPC/EMFILE are real
                    # faults that must keep their traceback below.
                    pass
                except BaseException:  # noqa: BLE001 - worker must not fall
                    import traceback  # back into the template's read loop

                    traceback.print_exc()
                os._exit(0)
            if report_fd:
                # token -> pid report: the spawner's kill/reap paths need the
                # child pid before the worker ever registers with the head
                try:
                    os.write(report_fd, f"{token} {pid}\n".encode())
                except OSError:
                    pass


if __name__ == "__main__":
    main(
        sys.argv[1],
        sys.argv[2],
        sys.argv[3],
        sys.argv[4] == "remote" if len(sys.argv) > 4 else False,
        int(sys.argv[5]) if len(sys.argv) > 5 else 0,
    )
