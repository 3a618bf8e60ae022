"""Engine-backed rollout plane: actor-hosted ``LLMEngine`` replicas that
generate trajectories continuously (port of ``ray_tpu/rlhf/rollout.py``).

Disaggregation shape (LlamaRL / MindSpeed RL): generation and learning
run on SEPARATE resources. Each ``RolloutWorker`` is an actor process
owning one continuous-batching ``LLMEngine`` whose step loop runs in a
daemon thread — exactly a serve replica minus HTTP. Every actor-facing
method is QUICK (submit/poll/update_weights touch queues and swap
pointers); the engine thread does the heavy work, so a weight push never
waits behind a long generation and the driver's poll cadence never
stalls generation.

Trajectory contract (what ``poll`` returns per finished request):

* ``tokens`` — the generated ids;
* ``logprobs`` — per-token BEHAVIOR logprobs captured at sample time
  (``models.sampling`` logprob convention) — the denominator of the
  learner's importance ratio, exact regardless of how many weight swaps
  happened mid-trajectory;
* ``weights_version`` — the engine's policy version at submit, the
  staleness gate's input;
* ``finish_reason`` / ``gen_s`` — bookkeeping.

``RolloutGroup`` is the driver-side handle: spawns N workers, fans
submits round-robin, harvests finished trajectories, and fans
``WeightUpdate`` pushes (the same chunk refs to every worker — one
serialization, N consumers).

Device adaptation (as ``device=`` is elsewhere in the port): a worker's
engine runs on its ``device`` (``None``: the card; the decode attention is
then the K1 kernel), and an actor-hosted worker on the card asks the
runtime for ``num_gpus`` of a GPU (default ``rl.learner.GPU_SHARE``, so
several workers and a remote learner share one card) and is bound to that
share of its node's cards by its index in the group
(``accelerators.gpu.card_share_options``). A worker opens CUDA only inside
its ``__init__``: nothing here imports torch at module import.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.rlhf.metrics import rlhf_metrics


class RolloutWorker:
    """One rollout engine; host in an actor via ``RolloutGroup`` (or use
    in-process for tests). ``sample_seed_base`` offsets the per-request
    sampling seeds so distinct workers explore distinct trajectories
    while staying fully deterministic."""

    def __init__(
        self,
        model: str = "gpt",
        model_cfg=None,
        engine_config=None,
        seed: int = 0,
        params: Optional[dict] = None,
        sample_seed_base: int = 0,
        warmup: bool = True,
        device=None,
    ):
        from ray_tpu_torch.llm.engine import LLMEngine
        from ray_tpu_torch.serve.llm import _build_model

        cfg, params, dev = _build_model(model, model_cfg, params, seed, device)
        self._engine = LLMEngine(cfg, params, engine_config, device=dev)
        if warmup:
            self._engine.warmup()
        self._seed_base = int(sample_seed_base)
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._pending: list[tuple] = []  # (Request, prompt, submit_t)
        self._stop = threading.Event()
        self._loop = threading.Thread(
            target=self._engine.run_loop, args=(self._stop,),
            name="rlhf-rollout-loop", daemon=True,
        )
        self._loop.start()

    # -- data plane (all quick: the engine thread does the real work) ------

    def submit(
        self,
        prompts: list,
        max_tokens: int = 16,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
    ) -> int:
        """Queue prompts for generation; returns the worker's pending
        count AFTER the submit (driver-side refill accounting)."""
        from ray_tpu_torch.llm.scheduler import SamplingParams

        if not self._loop.is_alive():
            raise RuntimeError("rollout engine loop thread died")
        now = time.time()
        with self._lock:
            for prompt in prompts:
                params = SamplingParams(
                    max_tokens=max_tokens,
                    temperature=temperature,
                    top_k=top_k,
                    top_p=top_p,
                    seed=self._seed_base + next(self._seq),
                )
                req = self._engine.submit([int(t) for t in prompt], params)
                self._pending.append((req, list(prompt), now))
            return len(self._pending)

    def poll(self) -> dict:
        """Harvest finished trajectories: ``{"trajs": [...], "pending": n}``."""
        now = time.time()
        with self._lock:
            done = [p for p in self._pending if p[0].finished]
            self._pending = [p for p in self._pending if not p[0].finished]
            pending = len(self._pending)
        trajs = [
            {
                "prompt": prompt,
                "tokens": list(req.out),
                "logprobs": list(req.out_logprobs),
                "weights_version": req.weights_version,
                "finish_reason": req.finish_reason,
                "gen_s": now - t0,
            }
            for req, prompt, t0 in done
        ]
        return {"trajs": trajs, "pending": pending}

    # -- control plane -----------------------------------------------------

    def update_weights(self, update, timeout: float = 120.0) -> int:
        """Apply a published ``WeightUpdate`` (or ``(params, version)``)
        between engine steps — in-flight generation keeps running
        (``LLMEngine.update_weights``)."""
        from ray_tpu_torch.rlhf.sync import apply_weight_update

        return apply_weight_update(self._engine, update, timeout=timeout)

    def weights_version(self) -> int:
        return self._engine.weights_version

    def stats(self) -> dict:
        s = self._engine.stats()
        with self._lock:
            s["rollout_pending"] = len(self._pending)
        return s

    def check_health(self) -> None:
        if not self._loop.is_alive():
            raise RuntimeError("rollout engine loop thread died")

    def stop(self) -> bool:
        self._stop.set()
        return True


class RolloutGroup:
    """Driver-side handle over N actor-hosted rollout workers.

    ``remote=False`` keeps a single in-process worker (unit tests, and
    debugging without a cluster); the API is identical.
    """

    def __init__(
        self,
        num_workers: int = 1,
        worker_kwargs: Optional[dict] = None,
        remote: bool = True,
        num_cpus: float = 1,
        num_gpus: Optional[float] = None,
    ):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        kwargs = dict(worker_kwargs or {})
        self._remote = remote
        self._rr = 0
        self._workers: list = []
        if remote:
            import ray_tpu_torch
            from ray_tpu_torch.accelerators.gpu import card_share_options
            from ray_tpu_torch.rl.learner import GPU_SHARE, gpu_share

            gpus = gpu_share(kwargs.get("device"), GPU_SHARE if num_gpus is None else num_gpus)
            cls = ray_tpu_torch.remote(RolloutWorker)
            for i in range(num_workers):
                wk = dict(kwargs)
                # disjoint seed lanes per worker: deterministic yet diverse
                wk["sample_seed_base"] = (
                    kwargs.get("sample_seed_base", 0) + i * 1_000_003
                )
                self._workers.append(
                    cls.options(num_cpus=num_cpus, **card_share_options(i, gpus)).remote(**wk)
                )
        else:
            if num_workers != 1:
                raise ValueError("remote=False supports a single worker")
            self._workers.append(RolloutWorker(**kwargs))

    @property
    def num_workers(self) -> int:
        return len(self._workers)

    def submit(self, prompts: list, timeout: float = 60.0, **sampling) -> int:
        """Round-robin one batch of prompts onto the next worker; returns
        that worker's resulting pending count."""
        w = self._workers[self._rr % len(self._workers)]
        self._rr += 1
        _events.record(
            "rlhf.rollout.submit", n=len(prompts),
            worker=(self._rr - 1) % len(self._workers),
        )
        if not self._remote:
            return w.submit(prompts, **sampling)
        import ray_tpu_torch

        return ray_tpu_torch.get(w.submit.remote(prompts, **sampling), timeout=timeout)

    def submit_to(self, idx: int, prompts: list, timeout: float = 60.0, **sampling) -> int:
        """Targeted submit (the refill loop keeps EVERY worker saturated,
        which round-robin alone cannot when workers drain unevenly)."""
        w = self._workers[idx]
        _events.record("rlhf.rollout.submit", n=len(prompts), worker=idx)
        if not self._remote:
            return w.submit(prompts, **sampling)
        import ray_tpu_torch

        return ray_tpu_torch.get(w.submit.remote(prompts, **sampling), timeout=timeout)

    def poll(self, timeout: float = 60.0) -> tuple[list[dict], list[int]]:
        """Harvest every worker once: (trajectories, per-worker pending).
        Each harvested trajectory records an ``rlhf.rollout.finish`` event
        in the DRIVER's ring (the overlap proof the smoke test reads) and
        counts into ``rlhf_rollout_tokens``."""
        if self._remote:
            import ray_tpu_torch

            outs = ray_tpu_torch.get(
                [w.poll.remote() for w in self._workers], timeout=timeout
            )
        else:
            outs = [w.poll() for w in self._workers]
        trajs: list[dict] = []
        pending: list[int] = []
        for i, out in enumerate(outs):
            pending.append(out["pending"])
            for t in out["trajs"]:
                t["worker"] = i
                trajs.append(t)
        if trajs:
            m = rlhf_metrics()
            m["rollout_trajs"].inc(len(trajs))
            m["rollout_tokens"].inc(sum(len(t["tokens"]) for t in trajs))
            for t in trajs:
                _events.record(
                    "rlhf.rollout.finish", worker=t["worker"],
                    tokens=len(t["tokens"]),
                    weights_version=t["weights_version"],
                    reason=t["finish_reason"], gen_s=round(t["gen_s"], 4),
                )
        return trajs, pending

    def push_weights(self, update) -> list:
        """Fan one ``WeightUpdate`` to every worker WITHOUT waiting —
        returns the ack refs (version numbers) so the caller can harvest
        them later; generation never drains (``rlhf.sync`` module doc)."""
        if not self._remote:
            return [self._workers[0].update_weights(update)]
        return [w.update_weights.remote(update) for w in self._workers]

    def versions(self, timeout: float = 30.0) -> list[int]:
        if not self._remote:
            return [self._workers[0].weights_version()]
        import ray_tpu_torch

        return ray_tpu_torch.get(
            [w.weights_version.remote() for w in self._workers], timeout=timeout
        )

    def shutdown(self) -> None:
        import ray_tpu_torch

        from ray_tpu_torch._private.log_util import warn_throttled

        for w in self._workers:
            try:
                if self._remote:
                    ray_tpu_torch.kill(w)
                else:
                    w.stop()
            except Exception as e:
                # best-effort teardown, but never silent: a leaked rollout
                # actor keeps generating against dead weights forever
                warn_throttled("rlhf rollout group teardown", e)
