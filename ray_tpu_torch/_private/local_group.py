"""One leader and its followers on the local cards: the machinery that the
tensor-parallel engine (``llm._tp_worker``) and the data-parallel learner
(``rl._dp_worker``) share.

One process per card. The caller's process is rank 0, the leader; it
starts ``size - 1`` followers itself, each a fresh interpreter running the
``main`` of a follower module (``python -c "from MODULE import main;
main()" SPEC``: spawn semantics, never a fork, so a leader that already
holds a CUDA context can start them, and the leader's ``__main__`` is
never imported again). Each follower takes its own card, ``(leader's
index + rank) % visible`` of the cards the leader sees, or the CPU when
the leader runs there.

**The group.** The ranks join a PRIVATE process group built straight from
a ``TCPStore`` on localhost (``ProcessGroupNCCL`` on the card,
``ProcessGroupGloo`` on the CPU). Nothing calls ``init_process_group``: a
caller's default group (a trainer's, a mesh's) is never touched, and a
group can live beside one.

**The control channel.** Each follower's stdin is a pipe from the leader;
the leader writes one command at a time on it: a fixed header of
``HEADER`` int64 (the operation, the payload's bytes and six fields) and
the payload. A follower blocks on the pipe between commands, so an idle
group leaves no collective pending (a pending NCCL collective trips the
group's timeout), and EOF on the pipe means the leader is gone. Replies
come back as JSON lines on the follower's stdout, which the follower keeps
for them alone (its prints go to stderr).

**Lifecycle.** A follower exits when its pipe reaches EOF, and a watcher
thread ends it within ``WATCH_S`` when its parent pid changes (a leader
killed while the follower waits in a collective). The leader stops its
followers on ``close`` and at collection. A follower that died makes the
leader's next command raise (``LocalGroup.check``); one that dies while
the leader waits in a collective is seen by the leader's own watcher,
which aborts the group within ``WATCH_S`` so the collective returns
(``_watch_followers``).

**Heartbeats.** A follower whose process stops without dying (SIGSTOP, an
interpreter that hangs) holds its sockets open, so its peers would wait in
the collective until the group's timeout. Each follower therefore runs a
thread that writes one byte every ``HEARTBEAT_S`` on a pipe of its own
(never the reply pipe, so a beat cannot split a reply); the leader's
watcher reads them, and a follower silent for ``STALE_S`` is treated as
one that exited: the group is marked broken, the follower is killed (on
the CPU a gloo collective returns only when its peer's sockets close) and
the group aborted, so the command in flight raises within about
``STALE_S`` naming the rank. A card that wedges while its process runs
still beats: this catches a stopped process, not a stopped card.
"""

from __future__ import annotations

import datetime
import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
import weakref
from typing import Optional

import numpy as np

#: header length in int64: (op, payload bytes, six fields)
HEADER = 8
#: seconds a watcher sleeps between checks (the leader's of its followers,
#: a follower's of its parent)
WATCH_S = 0.5
#: seconds between a follower's heartbeats, and the silence after which the
#: leader counts it dead. The beat thread is plain Python, so it stalls only
#: while another thread holds the interpreter lock in one C call. Torch
#: releases the lock in its operators, its collectives' waits and its CUDA
#: synchronizations, and the kernels' builds run ``nvcc`` in a subprocess:
#: the longest holds seen are a shared library's load (``import torch``,
#: 1-3 s) and the unpickling of a command's arrays (well under a second for
#: a GPT-124M's weights). A GPT-J-6B prefill at tp 4 or a first-use build
#: leaves the thread running. 20 s is ten times the longest of them and
#: still far inside the group's 600 s timeout.
HEARTBEAT_S = 0.5
STALE_S = 20.0
#: a follower's seconds to start, join the group and say hello, and the
#: group's collective timeout
START_TIMEOUT_S = 300.0
GROUP_TIMEOUT_S = 600.0


# -- the group --------------------------------------------------------------


def make_group(backend: str, port: int, rank: int, size: int, store=None):
    """A private process group of ``size`` ranks over the TCPStore at
    localhost:``port`` (the leader passes its own ``store``)."""
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if store is None:
        store = dist.TCPStore("127.0.0.1", port, size, False, timeout=timeout)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return store, dist.ProcessGroupNCCL(store, rank, size, opts)
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = timeout
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    return store, dist.ProcessGroupGloo(store, rank, size, opts)


class Collectives:
    """The collectives the groups use, over one backend object, rooted at
    rank 0."""

    def __init__(self, pg):
        self.pg = pg

    def all_reduce(self, t):
        """Sum ``t`` over the group in place."""
        self.pg.allreduce([t]).wait()
        return t

    def all_gather(self, t) -> list:
        """Every rank's ``t`` (of equal shapes), in rank order."""
        import torch

        out = [torch.empty_like(t) for _ in range(self.pg.size())]
        self.pg.allgather([out], [t.contiguous()]).wait()
        return out

    def broadcast(self, t):
        import torch.distributed as dist

        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        self.pg.broadcast([t], opts).wait()

    def scatter(self, out, parts=None):
        """Rank 0 hands rank r ``parts[r]``; every rank receives into
        ``out``."""
        import torch.distributed as dist

        opts = dist.ScatterOptions()
        opts.rootRank = 0
        self.pg.scatter([out], [list(parts)] if parts is not None else [], opts).wait()


# -- the control channel ----------------------------------------------------


def pack(op: int, fields=(), arrays=()) -> bytes:
    """One command whose payload is ``arrays``, all as int64."""
    payload = b"".join(np.ascontiguousarray(np.asarray(a), dtype=np.int64).reshape(-1).tobytes()
                       for a in arrays)
    return pack_bytes(op, fields, payload)


def pack_bytes(op: int, fields=(), payload: bytes = b"") -> bytes:
    """One command: the header and ``payload`` as it is."""
    head = np.zeros(HEADER, np.int64)
    head[0], head[1] = op, len(payload)
    head[2 : 2 + len(fields)] = fields
    return head.tobytes() + payload


def _read_exact(fd: int, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = os.read(fd, n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def read_command(fd: int):
    """(op, fields (6,), payload bytes), or None at EOF."""
    head = _read_exact(fd, HEADER * 8)
    if head is None:
        return None
    h = np.frombuffer(head, np.int64)
    body = _read_exact(fd, int(h[1])) if h[1] else b""
    if body is None:
        return None
    return int(h[0]), [int(x) for x in h[2:]], body


# -- the leader -------------------------------------------------------------


class LocalGroup:
    """The leader's side: its followers, their pipes, the group.

    ``size`` ranks, this process rank 0 on ``device`` (``cuda:i`` or
    ``cpu``); ``module`` names the follower's module (its ``main`` reads
    ``spec`` and this group's own keys: ``rank``, ``size``, ``port``,
    ``backend``, ``device``, ``beat_fd``, ``path``). ``name`` is the
    knob that set ``size``, for the message when too few cards are
    visible."""

    #: how errors name a follower
    ROLE = "follower"

    def __init__(self, size: int, device, module: str, spec: dict, name: str = "size"):
        import torch
        import torch.distributed as dist

        self.size, self.device = size, device
        self.broken: Optional[str] = None
        on_card = device.type == "cuda"
        visible = torch.cuda.device_count() if on_card else 0
        if on_card and visible < size:
            raise ValueError(f"{name}={size} needs {size} visible cards, {visible} visible")
        self.devices = [
            f"cuda:{((device.index or 0) + r) % visible}" if on_card else "cpu" for r in range(size)
        ]
        backend = "nccl" if on_card else "gloo"
        timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
        store = dist.TCPStore("127.0.0.1", 0, size, True, timeout=timeout, wait_for_workers=False)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        # the leader's import path, so a follower can unpickle what the
        # leader's modules define
        path = [p for p in sys.path if p and os.path.isdir(p)]
        self.procs: list[subprocess.Popen] = []
        self._beats: list[int] = []
        try:
            for r in range(1, size):
                beat_r, beat_w = os.pipe()
                os.set_blocking(beat_r, False)
                self._beats.append(beat_r)
                try:
                    self.procs.append(subprocess.Popen(
                        [sys.executable, "-c", f"from {module} import main; main()",
                         json.dumps(dict(spec, rank=r, size=size, port=store.port, backend=backend,
                                         device=self.devices[r], beat_fd=beat_w, path=path))],
                        stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env, pass_fds=(beat_w,),
                    ))
                finally:
                    os.close(beat_w)
            # the finalizer holds the processes and the group, not this
            # object: collection of the owner (or interpreter exit) stops
            # the followers and then the group
            self._pg: dict = {}
            self._finalizer = weakref.finalize(self, _stop, self.procs, self._pg, self._beats)
            self.replies("hello", START_TIMEOUT_S)
            store_, pg = make_group(backend, store.port, 0, size, store=store)
        except BaseException:
            if hasattr(self, "_finalizer"):
                self._finalizer()
            else:
                _stop(self.procs, {}, self._beats)
            raise
        self._pg["pg"] = pg
        self._store, self.coll = store_, Collectives(pg)
        self.label = [_label(d, r) for r, d in enumerate(self.devices)]
        if self.procs:
            self._pg["watched"] = True  # the watcher closes the heartbeat pipes
            threading.Thread(target=_watch_followers,
                             args=(weakref.ref(self), self.procs, self._beats, self._pg, self.ROLE),
                             daemon=True, name=f"{self.ROLE}-watch").start()

    # -- health -----------------------------------------------------------

    def check(self, wait_s: float = 0.0) -> None:
        """Raise if the group is broken or a follower has exited, looking
        for ``wait_s`` more seconds for an exit: a dying follower's sockets
        close before its exit can be reaped, so a collective can fail on
        its peer a moment before ``poll`` sees it gone."""
        deadline = time.monotonic() + wait_s
        while self.broken is None:
            for r, p in enumerate(self.procs, 1):
                if p.poll() is not None:
                    self.broken = f"{self.ROLE} rank {r} (pid {p.pid}) exited with code {p.returncode}"
                    break
            if self.broken is None and time.monotonic() >= deadline:
                return
            time.sleep(0.05)
        raise RuntimeError(self.broken)

    # -- the channel ------------------------------------------------------

    def command(self, op: int, fields=(), arrays=()) -> None:
        """Send one command, its payload ``arrays`` as int64, to every
        follower (raising if one is gone)."""
        self.send([pack(op, fields, arrays)] * len(self.procs))

    def send(self, msgs) -> None:
        """Send follower r ``msgs[r - 1]`` (``pack``/``pack_bytes``)."""
        self.check()
        for r, (p, msg) in enumerate(zip(self.procs, msgs), 1):
            try:
                p.stdin.write(msg)
                p.stdin.flush()
            except (BrokenPipeError, OSError) as e:
                self.broken = f"{self.ROLE} rank {r} (pid {p.pid}) is gone: {e}"
                raise RuntimeError(self.broken) from None

    def replies(self, kind: str, timeout_s: float = GROUP_TIMEOUT_S) -> list[dict]:
        """One JSON reply line from each follower, in rank order, within
        ``timeout_s``; raises if a follower exits or stays silent."""
        out = []
        deadline = time.monotonic() + timeout_s
        for r, p in enumerate(self.procs, 1):
            line = b""
            fd = p.stdout.fileno()
            while not line.endswith(b"\n"):
                if self.broken is not None:  # the watcher saw this or another follower stop
                    raise RuntimeError(self.broken)
                left = deadline - time.monotonic()
                ready, _, _ = select.select([fd], [], [], max(0.0, min(left, 1.0)))
                if ready:
                    chunk = os.read(fd, 65536)
                    if not chunk:
                        rc = p.wait(timeout=30)
                        self.broken = f"{self.ROLE} rank {r} (pid {p.pid}) exited with code {rc} before its {kind}"
                        raise RuntimeError(self.broken)
                    line += chunk
                elif time.monotonic() >= deadline:
                    self.broken = f"{self.ROLE} rank {r} (pid {p.pid}) sent no {kind} within {timeout_s} s"
                    raise RuntimeError(self.broken)
            msg = json.loads(line)
            if msg.get("kind") != kind:
                raise RuntimeError(f"{self.ROLE} rank {r}: expected {kind}, got {msg}")
            out.append(msg)
        return out

    def guarded(self, run, *args):
        """Run the leader's part of a command. Over several ranks, wait for
        its device work and check the group before returning: an NCCL
        collective returns to the host at once, so a peer that stopped or
        died shows only as the stream waiting, and the watcher's abort
        leaves the collective's output unfinished, not raised; only after
        the wait does the result count (its caller reads it at once, so the
        wait costs little). A ``RuntimeError`` (a collective whose peer
        stopped or died) marks the group broken, so every later command
        raises too, and is raised again naming the follower when one was
        seen to stop or exit (looking up to 2 s for the exit: ``check``)."""
        try:
            out = run(*args)
            if self.procs:
                if self.device.type == "cuda":
                    import torch

                    torch.cuda.current_stream(self.device).synchronize()
                self.check()
            return out
        except RuntimeError as e:
            if not self.procs:
                raise
            if self.broken is None:
                try:
                    self.check(wait_s=2.0)
                except RuntimeError:
                    pass
                if self.broken is None:
                    self.broken = f"a command failed on the leader: {e}"
                    raise
            raise RuntimeError(self.broken) from e

    def close(self) -> None:
        """Stop the followers (idempotent)."""
        self.broken = self.broken or "the group was closed"
        self._finalizer()


def _watch_followers(ref, procs, beats, box: dict, role: str) -> None:
    """The leader's watcher: when a follower exits, or sends no heartbeat
    for ``STALE_S``, while the group is sound, mark the group broken, kill
    the silent follower and abort the group within ``WATCH_S``, so a
    command waiting in a collective for that rank returns (and then
    raises) instead of waiting out the group's timeout (a ``shutdown`` in
    its place waits for that collective too: on 4 H100s it hung). Beats
    queued while this thread could not run count as fresh. Ends with the
    group (closed, broken or collected)."""
    try:
        _watch(ref, procs, beats, box, role)
    finally:
        _close_fds(beats)


def _watch(ref, procs, beats, box: dict, role: str) -> None:
    last = [time.monotonic()] * len(procs)
    while True:
        time.sleep(WATCH_S)
        group = ref()
        if group is None or group.broken is not None:
            return
        now = time.monotonic()
        for i, fd in enumerate(beats):
            try:
                if os.read(fd, 4096):
                    last[i] = now
            except BlockingIOError:
                pass
        for r, p in enumerate(procs, 1):
            if p.poll() is not None:
                group.broken = f"{role} rank {r} (pid {p.pid}) exited with code {p.returncode}"
            elif now - last[r - 1] > STALE_S:
                group.broken = (f"{role} rank {r} (pid {p.pid}) sent no heartbeat for {now - last[r - 1]:.1f} s "
                                f"(STALE_S {STALE_S} s): its process is stopped or hung; killed")
                p.send_signal(signal.SIGKILL)
            if group.broken is not None:
                _abort(box)
                return
        del group


def _abort(box: dict) -> None:
    """Abort the group in ``box`` once (locally: nothing waits for a peer)."""
    pg = box.get("pg")
    if pg is not None and not box.get("aborted"):
        box["aborted"] = True
        try:
            pg.abort()
        except Exception as e:  # the command's own error, or the next check, still raises
            print(f"[ray_tpu_torch] local group abort: {e}", file=sys.stderr)


def _close_fds(fds) -> None:
    for fd in fds:
        try:
            os.close(fd)
        except OSError:
            pass


def _label(device: str, rank: int) -> str:
    """A rank's key in a per-device ledger: its card index on the card,
    its rank on the CPU (where every rank is ``cpu``)."""
    return device.split(":")[1] if device.startswith("cuda") else str(rank)


def _stop(procs, box: dict, beats=()) -> None:
    """Close the followers' pipes (EOF ends their loops), kill any that
    outlives a short wait, then abort and shut down this side of the group.
    An aborted NCCL group left to its destructor ends the process
    (``std::terminate`` at exit); aborted, then shut down, it ends cleanly
    (torch 2.11 on 4 H100s)."""
    for p in procs:
        try:
            p.stdin.close()
        except OSError:
            pass
    deadline = time.monotonic() + 10.0
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if p.stdout is not None:
            p.stdout.close()
    if not box.get("watched"):
        _close_fds(beats)
    pg = box.pop("pg", None)
    if pg is not None:
        _abort({"pg": pg, "aborted": box.get("aborted")})
        try:
            pg.shutdown()
        except Exception as e:
            print(f"[ray_tpu_torch] local group shutdown: {e}", file=sys.stderr)


# -- the follower -------------------------------------------------------------


def _watch_parent(ppid: int) -> None:
    """End this process when its leader is gone, even while the main
    thread waits inside a collective."""
    while True:
        time.sleep(WATCH_S)
        if os.getppid() != ppid:
            os._exit(3)


def _beat(fd: int) -> None:
    """Write one byte on the heartbeat pipe every ``HEARTBEAT_S``; a pipe
    with no reader left means the leader is gone."""
    while True:
        try:
            os.write(fd, b".")
        except BlockingIOError:  # the leader's watcher is behind: it drains the pipe whole
            pass
        except OSError:
            os._exit(3)
        time.sleep(HEARTBEAT_S)


class Follower:
    """A follower's end of the channel: ``spec`` (the leader's, with the
    group's keys), ``send`` for replies, ``commands()`` until EOF. Built
    first thing in a follower's ``main``, before torch is imported: the
    parent watch and the heartbeat start here."""

    def __init__(self, argv=None):
        self.spec = json.loads((argv or sys.argv)[1])
        for p in self.spec.get("path", ()):
            if p not in sys.path:
                sys.path.append(p)
        ppid = os.getppid()
        # the reply channel is the original stdout; anything printed from
        # here on goes to stderr
        self._reply = os.fdopen(os.dup(1), "wb")
        os.dup2(2, 1)
        threading.Thread(target=_watch_parent, args=(ppid,), daemon=True, name="parent-watch").start()
        beat_fd = self.spec.get("beat_fd")
        if beat_fd is not None:
            os.set_blocking(beat_fd, False)
            threading.Thread(target=_beat, args=(beat_fd,), daemon=True, name="heartbeat").start()

    def send(self, kind: str, **kw) -> None:
        self._reply.write((json.dumps(dict(kw, kind=kind, rank=self.spec["rank"])) + "\n").encode())
        self._reply.flush()

    def commands(self):
        """(op, fields, payload bytes) per command, until the leader closes
        the pipe or is gone."""
        fd = sys.stdin.fileno()
        while True:
            cmd = read_command(fd)
            if cmd is None:
                return
            yield cmd

    def set_device(self):
        """This rank's torch device, made current on the card (one torch
        thread on the CPU, where the ranks share the host's cores)."""
        import torch

        dev = torch.device(self.spec["device"])
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        return dev


def traced(run, device):
    """Run ``run()`` under ``torch.profiler``: this rank's view of it
    (``trace_summary``), from the call to the end of its device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        run()
        if on_card:
            torch.cuda.synchronize(device)
    return trace_summary(prof, (time.perf_counter() - t0) * 1e3)


def trace_summary(prof, wall_ms: float) -> dict:
    """One traced command on one rank: its host time, the union of its
    kernels' intervals on the card (``busy_ms``, 0 on the CPU, which has no
    device timeline) and of NCCL's alone."""
    from torch.autograd import DeviceType

    spans = [(e.time_range.start, e.time_range.end, "nccl" in e.name.lower()) for e in prof.events()
             if e.device_type == DeviceType.CUDA]

    def union(iv) -> float:
        busy, end = 0.0, float("-inf")
        for a, b in sorted(iv):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return busy / 1e3  # us -> ms

    return dict(wall_ms=wall_ms, kernels=len(spans), busy_ms=union([(a, b) for a, b, _ in spans]),
                nccl_ms=union([(a, b) for a, b, c in spans if c]))
