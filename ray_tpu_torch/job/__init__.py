"""ray_tpu_torch.job: job submission — run driver scripts ON the cluster (copy
of ``ray_tpu/job/__init__.py``).

Reference: ``dashboard/modules/job/job_manager.py:525`` (JobManager spawning
a per-job JobSupervisor actor :140 that runs the entrypoint as a subprocess)
plus the SDK (``dashboard/modules/job/sdk.py``). Simplified:
no REST daemon — the submission API talks straight to the cluster (the same
control plane the dashboard head would use), and the supervisor actor owns
the subprocess: spawn, log capture, status transitions, stop.

If the cluster has a TCP listener, the entrypoint subprocess receives
``RAY_TPU_ADDRESS`` so it can ``ray_tpu_torch.init(address=...)`` back into the
cluster that runs it (the reference sets RAY_ADDRESS the same way).
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
import time
import uuid
from typing import Optional

import ray_tpu_torch

_KV_PREFIX = "__jobs__/"

PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"


class JobSupervisor:
    """Actor owning one job's entrypoint subprocess (reference:
    ``job_manager.py:140`` JobSupervisor)."""

    def __init__(self, job_id: str, entrypoint: str, env_vars: dict, cwd: Optional[str]):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self._status = PENDING
        self._log: list[str] = []
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()
        self._env_vars = env_vars
        self._cwd = cwd
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        env = dict(os.environ)
        env.update(self._env_vars or {})
        try:
            from ray_tpu_torch._private.runtime import get_ctx

            ctx = get_ctx()
            addr = ctx.call("tcp_address")
            if addr:
                env.setdefault("RAY_TPU_ADDRESS", f"{addr[0]}:{addr[1]}")
                env.setdefault("RAY_TPU_AUTHKEY", ctx.call("auth_info"))
        except Exception:
            pass
        try:
            self._proc = subprocess.Popen(
                self.entrypoint,
                shell=True,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                env=env,
                cwd=self._cwd,
                start_new_session=True,  # stop() kills the whole group
            )
        except Exception as e:  # noqa: BLE001
            with self._lock:
                self._status = FAILED
                self._log.append(f"[supervisor] failed to spawn: {e!r}\n")
            return
        with self._lock:
            self._status = RUNNING
        for line in self._proc.stdout:
            with self._lock:
                self._log.append(line)
                if len(self._log) > 100_000:
                    del self._log[:50_000]
        rc = self._proc.wait()
        with self._lock:
            if self._status != STOPPED:
                self._status = SUCCEEDED if rc == 0 else FAILED
            self._log.append(f"[supervisor] exit code {rc}\n")

    def status(self) -> str:
        with self._lock:
            return self._status

    def logs(self) -> str:
        with self._lock:
            return "".join(self._log)

    def stop(self) -> bool:
        import signal

        with self._lock:
            if self._status not in (PENDING, RUNNING):
                return False
            self._status = STOPPED
            proc = self._proc
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            except Exception:
                proc.terminate()
        return True

    def ping(self) -> bool:
        return True


def _supervisor_name(job_id: str) -> str:
    return f"_job_supervisor:{job_id}"


def submit_job(
    entrypoint: str,
    *,
    submission_id: Optional[str] = None,
    env_vars: Optional[dict] = None,
    working_dir: Optional[str] = None,
) -> str:
    """Start ``entrypoint`` (a shell command) under a supervisor actor;
    returns the job id immediately (reference: ``JobSubmissionClient.submit_job``)."""
    from ray_tpu_torch._private.runtime import get_ctx

    job_id = submission_id or f"job_{uuid.uuid4().hex[:10]}"
    cls = ray_tpu_torch.remote(JobSupervisor)
    cls.options(
        name=_supervisor_name(job_id), lifetime="detached", max_concurrency=4,
        num_cpus=0,
    ).remote(job_id, entrypoint, env_vars or {}, working_dir)
    get_ctx().call(
        "kv_put",
        key=_KV_PREFIX + job_id,
        value=json.dumps(
            {"entrypoint": entrypoint, "submitted_at": time.time()}
        ).encode(),
    )
    return job_id


def _supervisor(job_id: str):
    return ray_tpu_torch.get_actor(_supervisor_name(job_id))


def get_job_status(job_id: str) -> str:
    try:
        return ray_tpu_torch.get(_supervisor(job_id).status.remote(), timeout=30)
    except ValueError:
        from ray_tpu_torch._private.runtime import get_ctx

        if get_ctx().call("kv_get", key=_KV_PREFIX + job_id) is not None:
            return STOPPED  # supervisor gone (cluster restartish) — terminal
        raise


def get_job_logs(job_id: str) -> str:
    return ray_tpu_torch.get(_supervisor(job_id).logs.remote(), timeout=30)


def stop_job(job_id: str) -> bool:
    stopped = ray_tpu_torch.get(_supervisor(job_id).stop.remote(), timeout=30)
    return bool(stopped)


def wait_job(job_id: str, timeout: float = 300.0) -> str:
    """Block until the job reaches a terminal state; returns it."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        st = get_job_status(job_id)
        if st in (SUCCEEDED, FAILED, STOPPED):
            return st
        time.sleep(0.2)
    raise TimeoutError(f"job {job_id} still {st!r} after {timeout}s")


def list_jobs() -> list[dict]:
    from ray_tpu_torch._private.runtime import get_ctx

    ctx = get_ctx()
    out = []
    for key in ctx.call("kv_keys", prefix=_KV_PREFIX):
        job_id = key[len(_KV_PREFIX):]
        meta = json.loads(ctx.call("kv_get", key=key).decode())
        try:
            status = get_job_status(job_id)
        except Exception:
            status = "UNKNOWN"
        out.append({"job_id": job_id, "status": status, **meta})
    return sorted(out, key=lambda j: j.get("submitted_at", 0))
