"""Process handles for forkserver-spawned workers + the template itself.

Shared by the head (local nodes) and node agents (remote hosts) — see
``worker_template.py`` for the forkserver design. Reference: the raylet's
worker pool process bookkeeping (``src/ray/raylet/worker_pool.h:152``).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Optional


class ForkedProc:
    """Handle for a worker forked by the template. Not our child (the
    template's ``SIGCHLD=SIG_IGN`` lets the kernel reap it), so liveness
    and termination use a **pidfd** where the platform has one: a raw pid
    can be recycled the moment the kernel reaps, and ``os.kill`` on a
    recycled pid signals an innocent process. The pidfd pins the identity —
    it refers to this exact process forever, and polls readable once it
    exits. Raw-pid fallback only where pidfd_open is unavailable."""

    __slots__ = ("pid", "_pidfd", "_exited")

    def __init__(self, pid: int):
        self.pid = pid
        self._pidfd: Optional[int] = None
        self._exited = False
        try:
            self._pidfd = os.pidfd_open(pid)
        except AttributeError:
            self._pidfd = None  # platform without pidfd: raw fallback
        except OSError as e:
            import errno

            self._pidfd = None
            # ESRCH = already reaped (the pid may ALREADY be recycled —
            # never signal it). Anything else (ENOSYS on pre-5.3 kernels,
            # EPERM in sandboxes) means THIS PLATFORM can't pidfd at all:
            # the process is fine, fall back to raw-pid liveness. Treating
            # those as "exited" made every forked worker read as dead, so
            # the health loop killed its actor at the first tick of any
            # task longer than the health interval.
            self._exited = e.errno == errno.ESRCH

    def _close(self) -> None:
        if self._pidfd is not None:
            try:
                os.close(self._pidfd)
            except OSError:
                pass
            self._pidfd = None

    close = _close

    def __del__(self):
        # plain os.close: safe from a finalizer (no locks, no RPC — see the
        # __del__ rule in runtime.py). Without this, every dropped handle
        # (kill paths, agent shutdown clear) leaks one fd.
        self._close()

    def _poll_exit(self, timeout_ms) -> bool:
        """True once the process has exited. poll(), NOT select(): pidfds
        on a busy head can exceed FD_SETSIZE (1024) and select raises."""
        import select

        p = select.poll()
        p.register(self._pidfd, select.POLLIN)
        try:
            return bool(p.poll(timeout_ms))
        except OSError:
            return True

    def is_alive(self) -> bool:
        if self._exited:
            return False
        if self._pidfd is not None:
            if self._poll_exit(0):  # pidfd readable = process exited
                self._exited = True  # pid may be recycled from here on:
                self._close()  # terminate/join must become no-ops
                return False
            return True
        try:
            os.kill(self.pid, 0)
            return True
        except PermissionError:
            # EPERM = the process EXISTS but we may not signal it (sandbox
            # seccomp/LSM — the same environments that deny pidfd_open).
            # Only ESRCH means gone; treating EPERM as death re-creates
            # the kill-every-live-worker bug this path exists to avoid.
            return True
        except OSError:
            self._exited = True
            return False

    def terminate(self) -> None:
        if self._exited:
            return  # exit observed: the raw pid may belong to a stranger now
        if self._pidfd is not None:
            try:
                signal.pidfd_send_signal(self._pidfd, signal.SIGTERM)
            except OSError:
                pass
            return
        try:
            os.kill(self.pid, signal.SIGTERM)
        except OSError:
            pass

    def join(self, timeout=None) -> None:
        if self._exited:
            return
        if self._pidfd is not None:
            if self._poll_exit(None if timeout is None else int(timeout * 1000)):
                self._exited = True
                self._close()
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.is_alive():
            if deadline is not None and time.monotonic() >= deadline:
                return
            time.sleep(0.005)


class TemplateProc:
    """Spawner-side handle of one node's forkserver template. ``fork``
    writes one token line to the template's stdin (atomic under PIPE_BUF;
    the lock orders writers in THIS process); False means the template is
    unusable and the caller should fall back to a cold Popen spawn.

    The template reports ``token pid`` lines over a dedicated pipe (fd
    passed via ``pass_fds``, NOT stdout — workers inherit the template's
    stdout for user prints); ``on_spawn(token, ForkedProc)`` fires from a
    reader thread so kill/reap paths know forked pids before registration."""

    def __init__(self, popen, report_r=None, on_spawn=None):
        self.popen = popen
        self.lock = threading.Lock()
        if report_r is not None:
            threading.Thread(
                target=self._report_loop,
                args=(report_r, on_spawn),
                name="template-report",
                daemon=True,
            ).start()

    def _report_loop(self, report_r, on_spawn):
        with os.fdopen(report_r, "r") as f:
            for line in f:
                try:
                    token, pid = line.split()
                    if on_spawn is not None:
                        # open the pidfd HERE, as close to the fork as
                        # possible, so the identity pin beats any reap
                        on_spawn(token, ForkedProc(int(pid)))
                except (ValueError, OSError):
                    continue

    def alive(self) -> bool:
        return self.popen.poll() is None

    def fork(self, token: str) -> bool:
        with self.lock:
            if self.popen.poll() is not None:
                return False
            try:
                self.popen.stdin.write((token + "\n").encode())
                self.popen.stdin.flush()
                return True
            except (OSError, ValueError):
                return False

    def shutdown(self):
        try:
            self.popen.stdin.close()  # EOF: template exits on its own
        except (OSError, ValueError):
            pass
        try:
            self.popen.terminate()
        except OSError:
            pass


def spawn_template(
    socket_path: str,
    authkey: bytes,
    node_id_bin: bytes,
    env: dict,
    remote: bool = False,
    on_spawn=None,
) -> Optional[TemplateProc]:
    """Start a forkserver template process (shared by the head for local
    nodes and by node agents for their hosts). None = platform can't."""
    if not hasattr(os, "fork"):  # pragma: no cover - non-posix
        return None
    import subprocess
    import sys

    report_r, report_w = os.pipe()
    os.set_inheritable(report_w, True)
    try:
        popen = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "ray_tpu_torch._private.worker_template",
                socket_path,
                authkey.hex(),
                node_id_bin.hex(),
                "remote" if remote else "local",
                str(report_w),
            ],
            env=env,
            stdin=subprocess.PIPE,
            pass_fds=(report_w,),
            start_new_session=False,
        )
    except OSError:
        os.close(report_r)
        os.close(report_w)
        return None
    os.close(report_w)  # template holds the only write end now
    return TemplateProc(popen, report_r=report_r, on_spawn=on_spawn)
