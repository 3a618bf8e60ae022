"""Node agent: the per-host daemon that joins a remote machine to a cluster.

Counterpart of the reference's raylet + ``ray start --address=`` node
launcher (``python/ray/scripts/scripts.py:566``, ``_private/services.py:1485``
— the raylet registers the node with GCS and owns the local worker pool).
TPU-first simplification: the agent is a thin spawn proxy — scheduling stays
centralized in the head; the agent's only jobs are (a) registering this
host's resources and (b) exec'ing worker processes when the head asks, each
of which dials the head's TCP control plane itself.

Run via ``python -m ray_tpu_torch start --address=HOST:PORT``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
from typing import Optional


def shutdown_conn(conn) -> None:
    """Force-close a multiprocessing Connection that another thread may be
    blocked recv'ing on. ``conn.close()`` alone only drops the fd-table
    entry — the in-flight read keeps the kernel file description open, so no
    FIN is sent and BOTH sides block forever. SHUT_RDWR interrupts the read
    and tears the TCP stream down immediately."""
    try:
        s = socket.socket(fileno=conn.fileno())
    except OSError:
        return
    try:
        s.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    finally:
        s.detach()
    try:
        conn.close()
    except OSError:
        pass


#: raylint RL017 — _procs is appended/pruned-by-rebind ONLY on the agent's
#: run thread; the stack-dump thread takes a GIL-atomic list snapshot
#: (iteration over either the old or the rebound list is correct — dumps
#: are best-effort diagnostics)
LOCKFREE = ("NodeAgent._procs: atomic",)


class NodeAgent:
    def __init__(
        self,
        address: str,
        authkey: bytes,
        resources: Optional[dict] = None,
        labels: Optional[dict] = None,
    ):
        from ray_tpu_torch._private.worker_main import connect_head

        self.address = address
        self.authkey = authkey
        self.resources = dict(resources or {"CPU": float(os.cpu_count() or 1)})
        self.labels = dict(labels or {})
        self._procs: list[subprocess.Popen] = []
        self._by_token: dict[str, subprocess.Popen] = {}
        # template-forked workers: token -> ForkedProc (pidfd-pinned).
        # Written by the template's report thread, read by kill/dump/
        # shutdown paths — always under _forked_lock.
        self._forked: dict[str, object] = {}
        self._forked_lock = threading.Lock()
        self._template = None
        self._stop = threading.Event()
        self.conn = connect_head(address, authkey)
        # This host's slice of the object plane: a local arena for workers'
        # writes plus a data server from which ANY node pulls this host's
        # objects directly (reference: each raylet's plasma store + object
        # manager; the head keeps only the directory — data_plane.py).
        from ray_tpu_torch._private import shm_store
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.data_plane import DataServer

        self.arena_name = None
        if GLOBAL_CONFIG.object_store_arena_bytes > 0:
            self.arena_name = shm_store.create_arena(
                GLOBAL_CONFIG.object_store_arena_bytes
            )
        import uuid as _uuid

        self._seg_prefix = f"rtps-{_uuid.uuid4().hex[:8]}-"
        self.data_server = DataServer(authkey)
        data_address = (self._my_ip(), self.data_server.port)
        self.conn.send(
            (
                "register_agent",
                {
                    "resources": self.resources,
                    "labels": self.labels,
                    "pid": os.getpid(),
                    "data_address": data_address,
                    "arena_name": self.arena_name,
                },
            )
        )
        kind, info = self.conn.recv()
        assert kind == "agent_ack", kind
        self.node_id_bin: bytes = info["node_id"]
        self._apply_shipped_config(info)

    def _apply_shipped_config(self, ack_info: dict) -> None:
        """Head-shipped ``_system_config`` overrides apply to THIS agent
        process and (via env) to every worker it spawns — a local
        ``RAY_TPU_*`` env var set by the operator still wins on this host."""
        from ray_tpu_torch._private import config as _cfg

        shipped = ack_info.get("config") or {}
        _cfg.apply_shipped(shipped)
        self._config_env = {
            f"RAY_TPU_{k.upper()}": str(getattr(_cfg.GLOBAL_CONFIG, k))
            for k in shipped
            if hasattr(_cfg.GLOBAL_CONFIG, k)
        }

    # -- serve loop --------------------------------------------------------

    def run(self) -> None:
        """Blocks serving spawn requests until the head hangs up for good
        (a restarted head is retried for head_reconnect_grace_s; the agent
        re-registers under its ORIGINAL node id so restored object
        locators stay routable — reference: raylet reconnect window,
        ray_config_def.h:56-60)."""
        self._send_lock = threading.Lock()
        threading.Thread(target=self._stats_loop, daemon=True).start()
        try:
            while not self._stop.is_set():
                try:
                    msg = self.conn.recv()
                except (EOFError, OSError):
                    if self._stop.is_set() or not self._reconnect():
                        break
                    continue
                if msg[0] == "spawn_worker":
                    self._spawn(msg[1])
                elif msg[0] == "free_shm":
                    # the head routed a free of an object living on THIS
                    # host (head._release_loc)
                    from ray_tpu_torch._private.log_util import warn_throttled
                    from ray_tpu_torch._private.shm_store import free_location

                    try:
                        free_location(msg[1])
                    except Exception as e:  # noqa: BLE001 - frees are best-effort
                        warn_throttled("node agent: free_shm", e)
                elif msg[0] == "dump_workers":
                    # on-demand stack dumps of THIS host's workers
                    # (reporter.py SIGUSR1 machinery) — off-thread, or the
                    # ~2s dump poll would stall spawn/kill/free handling
                    threading.Thread(
                        target=self._dump_workers, args=(msg[1]["req_id"],), daemon=True
                    ).start()
                elif msg[0] == "kill_worker":
                    # registration-timeout path: the head gave up on this
                    # spawn; kill it here so a wedged interpreter doesn't
                    # leak on the host (head.py _respawn_timed_out)
                    tok = msg[1].get("token", "")
                    p = self._by_token.pop(tok, None)
                    if p is not None and p.poll() is None:
                        p.terminate()
                    with self._forked_lock:
                        fp = self._forked.pop(tok, None)
                    if fp is not None:
                        fp.terminate()
                elif msg[0] == "exit":
                    break
        finally:
            self.shutdown()

    def start(self) -> "NodeAgent":
        threading.Thread(target=self.run, daemon=True).start()
        return self

    def _worker_env(self) -> tuple[dict, str]:
        import ray_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        for k, v in getattr(self, "_config_env", {}).items():
            env.setdefault(k, v)  # operator's explicit env still wins
        if self.arena_name:
            # workers write their objects into THIS host's arena; the head
            # receives only the locator (see WorkerContext.put_serialized)
            env["RAY_TPU_ARENA"] = self.arena_name
        else:
            env.pop("RAY_TPU_ARENA", None)
        # over-arena-cap objects get dedicated segments tagged with this
        # agent's prefix, so shutdown can sweep any the head never freed
        env["RAY_TPU_SEG_PREFIX"] = self._seg_prefix
        return env, pkg_root

    def _ensure_template(self):
        """This host's forkserver template (head._ensure_template analog;
        shared spawn_template helper). Replaced if it died."""
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        if not GLOBAL_CONFIG.worker_forkserver_enabled:
            return None
        tmpl = getattr(self, "_template", None)
        if tmpl is not None and tmpl.alive():
            return tmpl
        from ray_tpu_torch._private.proc_handles import spawn_template

        env, _ = self._worker_env()
        self._template = spawn_template(
            self.address,
            self.authkey,
            self.node_id_bin,
            env,
            remote=True,
            on_spawn=self._on_template_spawn,
        )
        return self._template

    def _on_template_spawn(self, token: str, proc) -> None:
        with self._forked_lock:
            self._forked[token] = proc

    def _spawn(self, info: dict) -> None:
        token = info.get("token", "")
        if not info.get("container"):
            tmpl = self._ensure_template()
            if tmpl is not None and tmpl.fork(token):
                self._prune_forked()  # every spawn path sweeps, or the
                return  # token->handle map (and its pidfds) grows forever
        env, pkg_root = self._worker_env()
        argv = [
            sys.executable,
            "-m",
            "ray_tpu_torch._private.worker_main",
            self.address,
            self.authkey.hex(),
            self.node_id_bin.hex(),
            token,
            "--remote",
        ]
        if info.get("container"):
            from ray_tpu_torch._private.runtime_env import container_wrap

            argv, env = container_wrap(argv, env, pkg_root, info["container"])
        popen = subprocess.Popen(argv, env=env)
        self._procs.append(popen)
        if token:
            self._by_token[token] = popen
        from ray_tpu_torch._private.reporter import reap_stack_file

        for p in self._procs:
            if p.poll() is not None:
                reap_stack_file(p.pid)
        self._procs = [p for p in self._procs if p.poll() is None]
        self._by_token = {t: p for t, p in self._by_token.items() if p.poll() is None}
        self._prune_forked()

    def _prune_forked(self) -> None:
        from ray_tpu_torch._private.reporter import reap_stack_file

        with self._forked_lock:
            dead = [t for t, fp in self._forked.items() if not fp.is_alive()]
            for t in dead:
                fp = self._forked.pop(t)
                reap_stack_file(fp.pid)
                fp.close()

    def _dump_workers(self, req_id: str) -> None:
        from ray_tpu_torch._private.reporter import dump_pids

        pids = [p.pid for p in self._procs if p.poll() is None]
        with self._forked_lock:
            pids += [fp.pid for fp in self._forked.values() if fp.is_alive()]
        try:
            stacks = dump_pids(pids)
            with self._send_lock:
                self.conn.send(("worker_stacks", {"req_id": req_id, "stacks": stacks}))
        except Exception:
            pass  # conn died: the head's dump call times out gracefully

    def _stats_loop(self) -> None:
        """Ship /proc node stats to the head every few seconds (reference:
        reporter_agent.py's periodic psutil report)."""
        import time as _time

        from ray_tpu_torch._private.reporter import node_stats

        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.log_util import warn_throttled

        while not self._stop.is_set():
            _time.sleep(GLOBAL_CONFIG.node_stats_report_interval_s)
            try:
                stats = node_stats()
                with self._send_lock:
                    self.conn.send(("agent_stats", stats))
            except Exception as e:
                # conn mid-reconnect: next tick retries
                warn_throttled("node agent: stats report", e)

    def _reconnect(self) -> bool:
        import time

        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch._private.worker_main import connect_head

        deadline = time.monotonic() + GLOBAL_CONFIG.head_reconnect_grace_s
        while time.monotonic() < deadline and not self._stop.is_set():
            try:
                conn = connect_head(self.address, self.authkey, retries=1)
                conn.send(
                    (
                        "register_agent",
                        {
                            "resources": self.resources,
                            "labels": self.labels,
                            "pid": os.getpid(),
                            "data_address": (self._my_ip(conn), self.data_server.port),
                            "arena_name": self.arena_name,
                            "node_id": self.node_id_bin,
                        },
                    )
                )
                kind, info = conn.recv()
                if kind != "agent_ack":
                    raise OSError(f"unexpected reattach reply {kind!r}")
                self.conn = conn
                self.node_id_bin = info["node_id"]
                self._apply_shipped_config(info)  # restarted head may differ
                return True
            except Exception:
                time.sleep(0.5)
        return False

    def _my_ip(self, conn=None) -> str:
        """The IP other hosts can reach this agent's data server on: the
        local address of the control connection to the head (routable by
        construction; '127.0.0.1' stays loopback for same-host tests)."""
        import socket as _socket

        try:
            s = _socket.socket(fileno=os.dup((conn or self.conn).fileno()))
            try:
                return s.getsockname()[0]
            finally:
                s.close()  # closes only the dup'd fd
        except OSError:
            return "127.0.0.1"

    def shutdown(self) -> None:
        self._stop.set()
        if self._template is not None:
            self._template.shutdown()
            self._template = None
        for p in self._procs:
            if p.poll() is None:
                p.terminate()
        with self._forked_lock:
            for fp in self._forked.values():
                fp.terminate()
            self._forked.clear()
        for p in self._procs:
            try:
                p.wait(timeout=3)
            except Exception:
                p.kill()
        self.data_server.shutdown()
        if self.arena_name:
            from ray_tpu_torch._private import shm_store

            shm_store.unlink_arena(self.arena_name)
        # sweep worker segments the head never freed (crashed producers,
        # refs alive at shutdown) — identifiable by this agent's prefix
        import glob as _glob

        for path in _glob.glob(f"/dev/shm/{self._seg_prefix}*"):
            try:
                os.unlink(path)
            except OSError:
                pass
        shutdown_conn(self.conn)
