"""The follower side of the tensor-parallel engine (``llm.multichip``): the
process group, the step protocol, the shard rules and the follower loop.

One process per card. The engine's process is rank 0, the leader; it
starts ``tp - 1`` followers itself, each a fresh interpreter running this
module's ``main`` (``python -c "from ray_tpu_torch.llm._tp_worker import
main; main()" SPEC``: spawn semantics, never a fork, so a leader that already holds a CUDA context can start
them, and the leader's ``__main__`` is never imported again). Each
follower takes its own card, ``(leader's index + rank) % visible`` of the
cards the leader sees, or the CPU when the leader runs there.

**The group.** The ranks join a PRIVATE process group built straight from
a ``TCPStore`` on localhost (``ProcessGroupNCCL`` on the card,
``ProcessGroupGloo`` on the CPU). Nothing calls ``init_process_group``: a
caller's default group (a trainer's, a mesh's) is never touched, and an
engine can live beside one. The group carries the weights (``scatter`` of
the column/row slices, ``broadcast`` of the replicated leaves) and the
layers' reductions (``allreduce``), nothing else.

**The control channel.** Each follower's stdin is a pipe from the leader;
each step the leader writes one command on it: a fixed header of
``HEADER`` int64 (the operation and its shapes) and the step's host arrays
as int64 (tokens, positions or ``base_pos``, block tables; ``start`` and
``n_valid`` ride in the header; the fork's ``src``/``dst``). A follower
blocks on the pipe between steps, so an idle engine leaves no collective
pending (a pending NCCL collective trips the group's timeout), and EOF on
the pipe means the leader is gone. Replies (bytes resident after the pool,
a weight swap or a report) come back as JSON lines on the follower's
stdout, which the follower keeps for them alone (its prints go to stderr).

**Lifecycle.** A follower exits when its pipe reaches EOF, and a watcher
thread ends it within ``WATCH_S`` when its parent pid changes (a leader
killed in the middle of a step, while the follower waits in a
collective). The leader stops its followers on ``close`` and at
collection. A follower that died makes the leader's next step raise
(``TPGroup.check``); one that dies during a step is seen by the leader's
own watcher, which aborts the group within ``WATCH_S`` so the step's
collective returns, and the step raises (``_watch_followers``).
"""

from __future__ import annotations

import datetime
import json
import os
import re
import select
import subprocess
import sys
import threading
import time
import weakref
from typing import Optional

import numpy as np

#: header length in int64: (op, payload length, six shape fields)
HEADER = 8
OP_PREFILL, OP_DECODE, OP_VERIFY, OP_FORK, OP_POOL, OP_SWAP, OP_REPORT, OP_TRACE = range(1, 9)
#: seconds a follower's watcher sleeps between parent checks
WATCH_S = 0.5
#: a follower's seconds to start, join the group and say hello, and the
#: group's collective timeout
START_TIMEOUT_S = 300.0
GROUP_TIMEOUT_S = 600.0
#: pool dtypes by the code the POOL command carries
DTYPES = ("float32", "bfloat16", "float16")


# -- shard rules ------------------------------------------------------------

#: parameters only the leader holds: it alone computes the final layernorm,
#: the lm head and the sampling (followers stop at the last layer's output)
LEADER_ONLY = re.compile(r"^(ln_f|lm_head)\.")
#: the Megatron split, by parameter path: column-parallel (output dim 0 of
#: an ``nn.Linear`` weight, and its bias) and row-parallel (input dim 1 of
#: the weight; its bias is replicated and added once, before the reduction,
#: by rank 0)
_COLUMN = re.compile(r"^blocks\.\d+\.(q|k|v|attn_qkv|mlp_in)\.(weight|bias)$")
_ROW = re.compile(r"^blocks\.\d+\.(attn_out|mlp_out)\.weight$")
_FUSED_QKV = re.compile(r"^blocks\.\d+\.attn_qkv\.(weight|bias)$")


def shard_dim(name: str) -> Optional[int]:
    """The dim of parameter ``name`` split over tp: 0 (column-parallel), 1
    (row-parallel) or None (replicated, or the leader's alone)."""
    if _COLUMN.match(name):
        return 0
    if _ROW.match(name):
        return 1
    return None


def local_shape(name: str, shape, tp: int) -> tuple:
    dim = shard_dim(name)
    shape = list(shape)
    if dim is not None:
        if shape[dim] % tp:
            raise ValueError(f"{name} of shape {tuple(shape)} does not split over tp={tp} at dim {dim}")
        shape[dim] //= tp
    return tuple(shape)


def local_slice(value, name: str, rank: int, tp: int):
    """Rank ``rank``'s part of the full parameter ``value`` (a view where it
    can be). GPT's fused qkv rows go in the mesh's tp-major order first
    (``parallel.sharding.qkv_order``), so each contiguous shard splits into
    its own heads' q, k and v."""
    dim = shard_dim(name)
    if dim is None or tp == 1:
        return value
    if _FUSED_QKV.match(name):
        from ray_tpu_torch.parallel.sharding import qkv_order

        value = value[qkv_order(value.shape[0], tp).to(value.device)]
    n = value.shape[dim] // tp
    return value.narrow(dim, rank * n, n)


def local_module(cfg, tp: int, device, leader: bool):
    """An empty model of ``cfg``'s class holding one rank's parameter
    shapes (``local_shape``), on ``device``; a follower's has no
    ``ln_f``/``lm_head``."""
    import torch
    from torch import nn

    from ray_tpu_torch.models.gptj import GPTJ, GPTJConfig

    if isinstance(cfg, GPTJConfig):
        model = GPTJ(cfg, device="meta")
    else:
        from ray_tpu_torch.models.gpt import GPT

        model = GPT(cfg, device="meta")
    if not leader:
        model.ln_f = None
        model.lm_head = None
    for path, p in list(model.named_parameters()):
        mod_path, _, leaf = path.rpartition(".")
        mod = model.get_submodule(mod_path) if mod_path else model
        t = torch.empty(local_shape(path, p.shape, tp), dtype=p.dtype, device=device)
        mod._parameters[leaf] = nn.Parameter(t, requires_grad=False)
    return model.requires_grad_(False)


def storage_bytes(tensors) -> int:
    """Bytes of the tensors' storages, each counted once."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


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
    """The three collectives the engine uses, over one backend object,
    rooted at rank 0."""

    def __init__(self, pg):
        self.pg = pg

    def all_reduce(self, t):
        """Sum ``t`` over the group in place."""
        self.pg.allreduce([t]).wait()
        return t

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


def place(coll: Optional["Collectives"], local, full, tp: int, device) -> None:
    """Fill ``local`` (this rank's ``local_module``) from the full
    parameters: on the leader ``full`` is a ``{name: tensor}`` of the whole
    model, on any device, sent one parameter at a time (the transient is at
    most one full leaf); on a follower ``full`` is None and each parameter
    is received in place. ``coll`` is None at tp 1."""
    import torch

    leader = full is not None
    params = dict(local.named_parameters())
    names = list(full) if leader else list(params)
    with torch.no_grad():
        for name in names:
            dst = params[name]
            if leader:
                src = full[name]
                if LEADER_ONLY.match(name) or shard_dim(name) is None or tp == 1:
                    if dst.data_ptr() != src.data_ptr():  # an adopted tensor is its own source
                        dst.copy_(src)
                    if coll is not None and not LEADER_ONLY.match(name):
                        coll.broadcast(dst)
                else:
                    parts = [local_slice(src, name, r, tp).to(device, dst.dtype).contiguous()
                             for r in range(tp)]
                    coll.scatter(dst, parts)
                    del parts
            elif shard_dim(name) is None:
                coll.broadcast(dst)
            else:
                coll.scatter(dst)


# -- the control channel ----------------------------------------------------


def pack(op: int, fields=(), arrays=()) -> bytes:
    """One command: the header and the arrays, all int64."""
    payload = [np.ascontiguousarray(np.asarray(a), dtype=np.int64).reshape(-1) for a in arrays]
    n = sum(a.size for a in payload)
    head = np.zeros(HEADER, np.int64)
    head[0], head[1] = op, n
    head[2 : 2 + len(fields)] = fields
    return head.tobytes() + b"".join(a.tobytes() for a in payload)


def _read_exact(fd: int, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = os.read(fd, n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def read_command(fd: int):
    """(op, fields (6,), payload int64 array), or None at EOF."""
    head = _read_exact(fd, HEADER * 8)
    if head is None:
        return None
    h = np.frombuffer(head, np.int64)
    body = _read_exact(fd, int(h[1]) * 8) if h[1] else b""
    if body is None:
        return None
    return int(h[0]), [int(x) for x in h[2:]], np.frombuffer(body, np.int64)


class TPGroup:
    """The leader's side: its followers, their pipes, the group.

    ``device`` is the leader's (``cuda:i`` or ``cpu``); ``cfg`` the model
    config the followers rebuild their shards from."""

    def __init__(self, cfg, tp: int, device, block_size: int):
        import dataclasses

        import torch
        import torch.distributed as dist

        from ray_tpu_torch.models.gptj import GPTJConfig

        self.tp, self.device = tp, device
        self.broken: Optional[str] = None
        on_card = device.type == "cuda"
        visible = torch.cuda.device_count() if on_card else 0
        if on_card and visible < tp:
            raise ValueError(f"tp={tp} needs {tp} visible cards, {visible} visible")
        self.devices = [
            f"cuda:{((device.index or 0) + r) % visible}" if on_card else "cpu" for r in range(tp)
        ]
        backend = "nccl" if on_card else "gloo"
        timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
        store = dist.TCPStore("127.0.0.1", 0, tp, True, timeout=timeout, wait_for_workers=False)
        spec = dict(
            tp=tp, port=store.port, backend=backend, block_size=block_size,
            arch="gptj" if isinstance(cfg, GPTJConfig) else "gpt", cfg=dataclasses.asdict(cfg),
        )
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        self.procs: list[subprocess.Popen] = []
        try:
            for r in range(1, tp):
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", "from ray_tpu_torch.llm._tp_worker import main; main()",
                     json.dumps(dict(spec, rank=r, device=self.devices[r]))],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
                ))
            # the finalizer holds the processes and the group, not this
            # object: collection of the engine (or interpreter exit) stops
            # the followers and then the group
            self._pg: dict = {}
            self._finalizer = weakref.finalize(self, _stop, self.procs, self._pg)
            self.replies("hello", START_TIMEOUT_S)
            store_, pg = make_group(backend, store.port, 0, tp, store=store)
        except BaseException:
            self._finalizer()
            raise
        self._pg["pg"] = pg
        self._store, self.coll = store_, Collectives(pg)
        self.label = [_label(d, r) for r, d in enumerate(self.devices)]
        if self.procs:
            threading.Thread(target=_watch_followers, args=(weakref.ref(self), self.procs, self._pg),
                             daemon=True, name="tp-follower-watch").start()

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
                    self.broken = f"tp follower rank {r} (pid {p.pid}) exited with code {p.returncode}"
                    break
            if self.broken is None and time.monotonic() >= deadline:
                return
            time.sleep(0.05)
        raise RuntimeError(self.broken)

    # -- the channel ------------------------------------------------------

    def command(self, op: int, fields=(), arrays=()) -> None:
        """Send one command to every follower (raising if one is gone)."""
        self.check()
        msg = pack(op, fields, arrays)
        for r, p in enumerate(self.procs, 1):
            try:
                p.stdin.write(msg)
                p.stdin.flush()
            except (BrokenPipeError, OSError) as e:
                self.broken = f"tp follower rank {r} (pid {p.pid}) is gone: {e}"
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
                left = deadline - time.monotonic()
                ready, _, _ = select.select([fd], [], [], max(0.0, min(left, 1.0)))
                if ready:
                    chunk = os.read(fd, 65536)
                    if not chunk:
                        rc = p.wait(timeout=30)
                        self.broken = f"tp follower rank {r} (pid {p.pid}) exited with code {rc} before its {kind}"
                        raise RuntimeError(self.broken)
                    line += chunk
                elif time.monotonic() >= deadline:
                    self.broken = f"tp follower rank {r} (pid {p.pid}) sent no {kind} within {timeout_s} s"
                    raise RuntimeError(self.broken)
            msg = json.loads(line)
            if msg.get("kind") != kind:
                raise RuntimeError(f"tp follower rank {r}: expected {kind}, got {msg}")
            out.append(msg)
        return out

    def close(self) -> None:
        """Stop the followers (idempotent)."""
        self.broken = self.broken or "the tp group was closed"
        self._finalizer()


def _watch_followers(ref, procs, box: dict) -> None:
    """The leader's watcher: when a follower exits while the group is
    sound, mark the group broken and abort it within ``WATCH_S``, so a step
    waiting in a collective for the dead rank returns (and then raises,
    ``TensorParallelPagedModelRunner._guarded``) instead of waiting out the
    group's timeout (a ``shutdown`` in its place waits for that collective
    too: on 4 H100s it hung). Ends with the group (closed, broken or
    collected)."""
    while True:
        time.sleep(WATCH_S)
        group = ref()
        if group is None or group.broken is not None:
            return
        for r, p in enumerate(procs, 1):
            if p.poll() is not None:
                group.broken = f"tp follower rank {r} (pid {p.pid}) exited with code {p.returncode}"
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
        except Exception as e:  # the step's own error, or the next check, still raises
            print(f"[ray_tpu_torch] tp group abort: {e}", file=sys.stderr)


def _label(device: str, rank: int) -> str:
    """A rank's key in the per-device ledger: its card index on the card,
    its rank on the CPU (where every rank is ``cpu``)."""
    return device.split(":")[1] if device.startswith("cuda") else str(rank)


def _stop(procs, box: dict) -> None:
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
    pg = box.pop("pg", None)
    if pg is not None:
        _abort({"pg": pg, "aborted": box.get("aborted")})
        try:
            pg.shutdown()
        except Exception as e:
            print(f"[ray_tpu_torch] tp group shutdown: {e}", file=sys.stderr)


# -- the follower -------------------------------------------------------------


def _watch_parent(ppid: int) -> None:
    """End this process when its leader is gone, even while the main
    thread waits inside a collective."""
    while True:
        time.sleep(WATCH_S)
        if os.getppid() != ppid:
            os._exit(3)


def main(argv=None) -> None:
    spec = json.loads((argv or sys.argv)[1])
    ppid = os.getppid()
    # the reply channel is the original stdout; anything printed from here
    # on goes to stderr
    reply = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    threading.Thread(target=_watch_parent, args=(ppid,), daemon=True, name="tp-parent-watch").start()

    import torch

    from ray_tpu_torch.llm.multichip import _Follower

    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(torch.device(spec["device"]))

    def send(kind: str, **kw) -> None:
        reply.write((json.dumps(dict(kw, kind=kind, rank=spec["rank"])) + "\n").encode())
        reply.flush()

    send("hello", pid=os.getpid())
    follower = _Follower(spec)
    fd = sys.stdin.fileno()
    trace = False
    while True:
        cmd = read_command(fd)
        if cmd is None:  # EOF: the leader closed the pipe or is gone
            return
        if cmd[0] == OP_TRACE:
            trace = True  # the next command runs under the profiler
            continue
        out = traced(follower, cmd) if trace else follower.run(*cmd)
        trace = False
        if out is not None:
            kind, fields = out
            send(kind, **fields)


def traced(follower, cmd):
    """Run one command under ``torch.profiler`` and reply with this rank's
    view of it (``trace_summary``): from the command to the end of its
    device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = follower.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        follower.run(*cmd)
        if on_card:
            torch.cuda.synchronize(follower.device)
    return "trace", trace_summary(prof, (time.perf_counter() - t0) * 1e3)


def trace_summary(prof, wall_ms: float) -> dict:
    """One traced step on one rank: its host time, the union of its
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

