"""serve.llm: stream-first LLM serving on the port's engine
(``ray_tpu_torch.llm``; port of ``ray_tpu/serve/llm.py``).

``LLMDeployment`` runs one ``LLMEngine`` inside each replica: a daemon
thread turns the engine crank while replica request threads submit and
stream.  ``__call__`` is a GENERATOR, so the serve stack's existing
streaming-generator machinery does the rest — callers use

    handle = serve.run(build_llm_app(model="gptj", model_cfg=cfg))
    for tok in handle.options(stream=True).remote([1, 2, 3],
                                                  max_tokens=32):
        ...

and tokens cross the cluster as they are sampled (TTFT ≈ one prefill +
one decode step, not the whole completion).  ``generate`` is the
blocking whole-completion method for non-streaming callers (a generator
return can't pickle through ``handle_request``).

Devices: a replica's engine runs on ``device`` — ``None`` (the default)
means the card, ``"cpu"`` is for tests. On the card, ``build_llm_app``
gives every replica ``ray_actor_options={"num_gpus": 1}``, so the runtime
places it on a node with a free GPU and only there; on a cluster with no
GPU ``serve.run`` raises (the controller refuses the deployment) and no
engine is ever built on the CPU in its place. The weights are drawn inside
the replica, on its device, from ``seed`` (``gptj_init``/``gpt_init`` with
a ``torch.Generator`` on that device), unless ``params`` (a port parameter
module, e.g. from ``models.gptj.params_from_jax``) is bound.

This module imports no torch at its top: the serve controller unpickles
nothing of a spec (``_private.common.Sealed``), but a process that imports
this module to name ``LLMDeployment`` or ``build_llm_app`` must still stay
free of torch until it builds an engine. The engine and the models are
imported where they are used, inside the replica.

Autoscaling: the replica exports the engine's queue depth and KV-cache
utilization — through ``util.metrics`` gauges (``llm_*`` series) and
through ``autoscaling_metrics()``, which the serve controller's scaling
decision CONSUMES (``_private/controller.desired_replicas``: queued
requests count as load; a KV-saturated replica adds upscale pressure).
Since a continuous-batching replica absorbs many concurrent requests per
slot set, ongoing-request counts alone under-report saturation; queue
depth (> 0 means the engine is admission-bound) and KV utilization
(≈ 1.0 means preemption-bound) are the honest signals.
"""

from __future__ import annotations

import threading
from typing import Optional


def on_card(device) -> bool:
    """Whether ``device`` names the card (``None`` means the card)."""
    return device is None or str(device).split(":")[0] == "cuda"


def _build_model(model: str, model_cfg, params, seed: int, device):
    """Materialize (cfg, params) inside the replica — shipping a seed
    instead of a parameter module keeps deployment specs small and lets
    each replica draw its weights straight onto its own device."""
    import torch

    from ray_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if model == "gptj":
        from ray_tpu_torch.models.gptj import GPTJ_6B, GPTJConfig, gptj_init

        cfg = model_cfg or GPTJ_6B
        if not isinstance(cfg, GPTJConfig):
            raise TypeError(f"model_cfg must be a GPTJConfig, got {type(cfg).__name__}")
        init = gptj_init
    elif model == "gpt":
        from ray_tpu_torch.models.gpt import GPTConfig, gpt_init

        cfg = model_cfg or GPTConfig()
        if not isinstance(cfg, GPTConfig):
            raise TypeError(f"model_cfg must be a GPTConfig, got {type(cfg).__name__}")
        init = gpt_init
    else:
        raise ValueError(f"unknown model family {model!r}; expected 'gptj' or 'gpt'")
    if params is None:
        params = init(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    elif params.lm_head.weight.device != dev:
        params = params.to(dev)
    return cfg, params, dev


class LLMDeployment:
    """The replica callable. Decorate/bind via ``build_llm_app`` (or apply
    ``serve.deployment`` yourself for custom replica options)."""

    def __init__(
        self,
        model: str = "gptj",
        model_cfg=None,
        params=None,
        engine_config=None,
        seed: int = 0,
        warmup: bool = True,
        stream_timeout_s: float = 300.0,
        draft_model_cfg=None,
        draft_params=None,
        device=None,
        tp: Optional[int] = None,
    ):
        from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine

        if tp is not None:  # build_llm_app's overlay, applied here so its caller needs no torch
            import dataclasses

            engine_config = dataclasses.replace(engine_config or EngineConfig(), tp=tp)
        cfg, params, dev = _build_model(model, model_cfg, params, seed, device)
        # speculative decoding with the small-model drafter
        # (engine_config.spec_drafter == "model"): the draft model's
        # config + params pass straight through to the engine; the
        # default n-gram drafter needs neither
        if draft_model_cfg is not None and draft_params is None:
            _, draft_params, _ = _build_model(model, draft_model_cfg, None, seed, dev)
        #: max wait for the next streamed token — must cover the ADMISSION
        #: wait of a request queued behind a saturated engine, not just
        #: inter-token gaps (the engine's own 60s default is too tight for
        #: a deployment whose whole point is absorbing a deep queue)
        self._stream_timeout_s = stream_timeout_s
        self._engine = LLMEngine(
            cfg, params, engine_config,
            draft_model_cfg=draft_model_cfg, draft_params=draft_params,
            device=dev,
        )
        # per-engine watchdog (llm.watchdog): stall detection, wedge-proof
        # deadline/cancel reaping, KV-pool leak audit — a serving replica
        # always runs one
        self._engine.start_watchdog()
        if warmup:
            # drive the prefill/decode/verify paths NOW, inside replica
            # creation, so serve.run's readiness gate covers kernel loading
            # and library initialization and the first real request streams
            # at steady-state latency (covers BOTH decode paths of a
            # speculating engine — see LLMEngine.warmup)
            self._engine.warmup()
        self._stop = threading.Event()
        self._loop = threading.Thread(
            target=self._engine.run_loop, args=(self._stop,),
            name="llm-engine-loop", daemon=True,
        )
        self._loop.start()

    # -- request path ------------------------------------------------------

    def __call__(
        self,
        prompt: list,
        max_tokens: int = 16,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        stop_token_ids: tuple = (),
        seed: int = 0,
        deadline_s: Optional[float] = None,
        resume_tokens: tuple = (),
    ):
        """Streaming generation: yields token ids as the engine samples
        them. Call with ``handle.options(stream=True)``; the generator
        shape is what routes this through ``handle_request_streaming``.

        ``prompt`` may also be a dict — ``{"prompt": [...], "max_tokens":
        32, "temperature": 0.8, ...}`` — so HTTP callers (whose JSON body
        arrives as the single positional payload) can set sampling knobs
        and a ``deadline_s``; dict keys override the keyword defaults.

        ``resume_tokens`` is the mid-stream failover journal (the handle
        layer injects it via the deployment's ``stream_resume_arg``
        contract): tokens a dead replica already delivered. Generation
        continues AFTER them, token-identically (``LLMEngine.submit``).
        A dict payload's own ``resume_tokens`` (a client-side resume)
        concatenates with the handle-injected journal.
        """
        from ray_tpu_torch.llm.scheduler import SamplingParams

        if isinstance(prompt, dict):
            body = dict(prompt)
            try:
                prompt = body.pop("prompt")
            except KeyError:
                raise ValueError("dict payload requires a 'prompt' key") from None
            max_tokens = body.pop("max_tokens", max_tokens)
            temperature = body.pop("temperature", temperature)
            top_k = body.pop("top_k", top_k)
            top_p = body.pop("top_p", top_p)
            stop_token_ids = body.pop("stop_token_ids", stop_token_ids)
            seed = body.pop("seed", seed)
            deadline_s = body.pop("deadline_s", deadline_s)
            # client-resumed prefix first, then the failover journal
            resume_tokens = tuple(body.pop("resume_tokens", ())) + tuple(
                resume_tokens
            )
            if body:
                raise ValueError(f"unknown payload keys: {sorted(body)}")
        params = SamplingParams(
            max_tokens=max_tokens,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            stop_token_ids=tuple(stop_token_ids),
            seed=seed,
        )
        req = self._engine.submit(
            [int(t) for t in prompt], params, deadline_s,
            resume_tokens=tuple(int(t) for t in resume_tokens),
        )
        # with an explicit deadline the engine itself ends the stream at
        # the deadline; the get-timeout only needs to outlast it
        timeout = (
            deadline_s + 5.0 if deadline_s is not None else self._stream_timeout_s
        )
        try:
            yield from self._engine.stream_tokens(req, timeout=timeout)
        finally:
            # consumer walked away (stream closed/replica thread unwinding):
            # stop generating for nobody
            if not req.finished:
                self._engine.cancel(req.id)

    def generate(self, prompt: list, **kwargs) -> list:
        """Blocking whole-completion variant for non-streaming callers."""
        return list(self.__call__(prompt, **kwargs))

    # -- control plane -----------------------------------------------------

    def update_weights(self, update, version=None, timeout: float = 120.0) -> int:
        """Versioned weight hot-swap — the SAME push path raw actor
        engines use (``rlhf.sync.apply_weight_update`` →
        ``LLMEngine.update_weights``): accepts a published
        ``rlhf.sync.WeightUpdate`` manifest (chunked object-plane refs) or a
        port parameter module of the serving model's structure (on any
        device) + ``version``, and applies it between engine steps WITHOUT
        draining in-flight streams. An RLHF learner can therefore push to
        serve-hosted inference replicas and dedicated rollout actors with
        one code path:

            handle.update_weights.remote(weight_update).result()

        ``timeout`` bounds a manifest's chunk fetches. Routes like any other
        handle call (one replica per call); push once per replica — or use
        ``num_replicas=1`` engines for rollout duty — when every replica
        must advance."""
        from ray_tpu_torch.rlhf.sync import WeightUpdate, apply_weight_update

        if not isinstance(update, WeightUpdate):
            import torch

            if not isinstance(update, torch.nn.Module):
                raise TypeError(
                    "update_weights takes a WeightUpdate or a parameter module, got "
                    f"{type(update).__name__}"
                )
            # version=None lets LLMEngine.update_weights bump UNDER its
            # lock — computing current+1 here would race a concurrent
            # push into two different param sets sharing one version
            update = (update, version)
        return apply_weight_update(self._engine, update, timeout=timeout)

    def weights_version(self) -> int:
        return self._engine.weights_version

    def autoscaling_metrics(self) -> dict:
        """Saturation signals for replica autoscaling: ``queue_depth``
        (admission-bound) and ``kv_utilization`` (memory-bound) on top of
        the running count the controller already polls.
        ``prefix_hit_rate`` rides along informationally — the
        cross-request prefix cache (``llm.prefix_cache``) is per-replica,
        so routing that keeps a tenant's traffic on one replica shows up
        directly as a higher hit rate here.  Note ``kv_utilization`` counts
        only blocks live requests hold: cache-only residents are evictable
        on demand and never create upscale pressure."""
        s = self._engine.stats()
        m = {
            "queue_depth": s["queue_depth"],
            "kv_utilization": s["kv_utilization"],
            "running": s["running"],
            "waiting": s["waiting"],
        }
        if "prefix_cache" in s:
            m["prefix_hit_rate"] = s["prefix_cache"]["hit_rate"]
        return m

    def stats(self) -> dict:
        return self._engine.stats()

    def check_health(self) -> None:
        if not self._loop.is_alive():
            raise RuntimeError("LLM engine loop thread died")

    def __del__(self):
        try:
            self._stop.set()
        except Exception:  # raylint: disable=RL007
            pass  # interpreter teardown: the daemon thread dies with us


def build_llm_app(
    model: str = "gptj",
    model_cfg=None,
    engine_config=None,
    seed: int = 0,
    num_replicas: int = 1,
    max_ongoing_requests: int = 16,
    autoscaling_config=None,
    name: str = "LLMDeployment",
    warmup: bool = True,
    tp: Optional[int] = None,
    device=None,
):
    """Bind an ``LLMDeployment`` application (deploy with ``serve.run``).

    ``device`` — where each replica's engine runs: ``None`` (the default)
    means the card, and then every replica asks the runtime for one GPU
    (``ray_actor_options={"num_gpus": 1}``); ``"cpu"`` runs the engines on
    the CPU (tests) and asks for none.

    ``tp`` — tensor parallelism per replica (``llm.multichip``): a
    convenience overlay on ``engine_config.tp``. Each replica's engine
    starts ``tp - 1`` follower processes on the cards after its own; on
    the card the replica asks the runtime for ``num_gpus: tp``, so its node
    has those cards and the replica's process sees them (the runtime
    counts GPUs but binds a replica to no card index, ROADMAP §A8.1).
    ``autoscaling_metrics`` keeps reporting the POOL-WIDE
    ``kv_utilization`` — the block ledger is host-global under tp (every
    rank holds the same blocks' local heads).

    ``max_ongoing_requests`` should comfortably exceed the engine's
    ``max_slots`` — the whole point of continuous batching is holding
    more concurrent streams than decode slots and letting the engine's
    queue absorb the difference (queue depth then drives autoscaling).

    ``warmup=True`` (default) drives every step path inside replica
    ``__init__`` so the readiness gate covers it and first requests stream
    at steady-state latency. ``warmup=False`` trades that for FAST replica
    (re)join: a replacement replica becomes routable sooner and pays that
    inside its first request — the right trade when replicas churn (chaos,
    spot preemption) and a mid-stream failover must find a routable
    successor before the router's pick deadline, not after a full warmup.
    """
    from ray_tpu_torch.serve.api import deployment

    # the overlay itself is applied in the replica (``LLMDeployment``), so
    # this caller loads no torch
    cards = tp if tp is not None else getattr(engine_config, "tp", 1)
    dep = deployment(
        LLMDeployment,
        name=name,
        num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
        autoscaling_config=autoscaling_config,
        # a card per tp rank of a replica on the card; none on the CPU
        ray_actor_options={"num_gpus": cards} if on_card(device) else {},
        # mid-stream failover contract: a stream whose replica dies is
        # re-submitted with resume_tokens=<delivered tokens> and resumes
        # token-identically; deadline_s is re-submitted MINUS the time
        # already spent, so failovers never extend a client's declared
        # wait budget (RESILIENCE.md)
        stream_resume_arg="resume_tokens",
        stream_deadline_arg="deadline_s",
    )
    return dep.bind(
        model=model, model_cfg=model_cfg, engine_config=engine_config,
        seed=seed, warmup=warmup, device=device, tp=tp,
    )
