"""Training step on one device (port of ``ray_tpu/parallel/train_step.py``).

``build_train_step(loss_fn, optimizer)`` returns ``(init_fn, step_fn)`` as
the reference does: ``init_fn`` places the parameters and builds the
optimizer, ``step_fn(state, batch)`` runs the forward, the backward and the
optimizer update. The reference donates its state to a jitted step; here
the parameters and the optimizer's moments are updated in place.
``profile_step_fn`` wraps a step with the device-step profiler, as the
reference's does. The mesh, sharding, ZeRO placement and ``global_put``
belong to the multichip slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ray_tpu_torch.device import resolve_device


class TrainState(NamedTuple):
    params: torch.nn.Module
    opt_state: torch.optim.Optimizer
    step: int


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Callable[[Any], torch.optim.Optimizer]:
    """A factory ``params -> torch.optim.AdamW`` with ``optax.adamw``'s
    defaults. ``torch.optim.AdamW`` defaults to ``weight_decay=1e-2``; optax
    to 1e-4. Both decay every parameter and apply the decay as
    ``p -= lr * weight_decay * p`` beside the bias-corrected Adam step."""

    def make(params) -> torch.optim.Optimizer:
        return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay)

    return make


def build_train_step(
    loss_fn: Callable[[torch.nn.Module, torch.Tensor], torch.Tensor],
    optimizer: Callable[[Any], torch.optim.Optimizer],
):
    """Returns ``(init_fn, step_fn)``.

    ``loss_fn(params, batch) -> scalar`` is differentiated;
    ``init_fn(params, device=None)`` moves the parameters to ``device`` (the
    card unless the caller asks for the CPU) and builds the optimizer from
    the ``optimizer`` factory (``adamw``); ``step_fn(state, batch)`` returns
    ``(state, loss)`` with the loss detached on the device (no host sync).
    """

    def init_fn(params: torch.nn.Module, device=None) -> TrainState:
        params = params.to(resolve_device(device))
        return TrainState(params, optimizer(params.parameters()), 0)

    def step_fn(state: TrainState, batch: torch.Tensor):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, batch)
        loss.backward()
        opt.step()
        return state._replace(step=state.step + 1), loss.detach()

    return init_fn, step_fn


def profile_step_fn(step_fn, site: str = "train_step"):
    """Opt-in device-step profiling for a train step: host time per call
    into ``device_step_seconds{site=train_step}`` and runtime retrace
    detection (``train.retrace`` events + the ``device_retraces`` counter
    feeding the retrace-storm SLO — ``util.device_prof``).

    A WRAPPER, as the reference's is: the wrapped callable exposes
    ``.profiler`` (per-site stats) and ``.__wrapped__`` (the raw step). An
    eager step keeps no shape cache, so the profiler times it and never
    fires (``device_prof``'s plain-callable rule); a step that exposes
    ``_cache_size()`` is watched for new shapes."""
    import time

    from ray_tpu_torch.util.device_prof import JitProfiler

    prof = JitProfiler(event="train.retrace")

    def profiled(state, batch):
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        prof.note(site, step_fn, time.perf_counter() - t0)
        return out

    profiled.profiler = prof
    profiled.__wrapped__ = step_fn
    return profiled
