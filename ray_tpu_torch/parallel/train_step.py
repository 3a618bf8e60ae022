"""The training step, on one device or sharded over a mesh (port of
``ray_tpu/parallel/train_step.py``).

``build_train_step(loss_fn, optimizer, mesh=None)`` returns ``(init_fn,
step_fn)`` as the reference does: ``init_fn`` places the parameters and
builds the optimizer, ``step_fn(state, batch)`` runs the forward, the
backward and the optimizer update. The reference donates its state to a
jitted step; here the parameters and the optimizer's moments are updated in
place.

With a mesh (``parallel.mesh.make_mesh``) every rank calls both with the
same values: ``init_fn`` turns each parameter into a ``DTensor`` under the
rule table (``parallel.sharding``) and builds the optimizer's state at once,
so Adam's moments are ``DTensor``s with their parameter's placements, as
``_opt_shardings`` makes them in the reference. ``step_fn`` takes this
rank's ``(dp, fsdp)`` slice of the global batch (an ``sp`` group shares its
rows, and the model takes each member's chunk of the positions);
``loss_fn`` returns the mean over the rank's tokens, its backward is scaled
by ``1 / (dp * fsdp * sp)``, and the gathers of ``sharding.local`` sum the
ranks' gradients into each parameter's shard. The returned loss is the
mean over the global batch, the same on every rank (the ranks' means
averaged: equal to the reference's mean over the global batch to fp32
rounding).

``profile_step_fn`` wraps a step with the device-step profiler, as the
reference's does.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.parallel.mesh import axis_size
from ray_tpu_torch.parallel.sharding import (
    TOKEN_AXES,
    _is_fused_qkv,
    batch_spec,
    global_put,  # noqa: F401  (the reference exports it from here)
    is_dtensor,
    local_slices,
    param_sharding_rules,
    shard_params,
)


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


def _init_adam_state(opt: torch.optim.Optimizer) -> None:
    """Build an Adam or AdamW optimizer's per-parameter state now, as its
    first step would (``torch.optim.Adam._init_group``): the moments are
    ``zeros_like`` their parameter, ``DTensor``s with its placements on a
    mesh. The reference's ``optimizer.init`` builds its state up front too;
    other optimizers build theirs at their first step."""
    if not isinstance(opt, torch.optim.Adam | torch.optim.AdamW):
        return
    for group in opt.param_groups:
        on_device = group["capturable"] or group["fused"]
        for p in group["params"]:
            state = opt.state[p]
            if state:
                continue
            state["step"] = (torch.zeros((), dtype=torch.float32, device=p.device) if on_device
                             else torch.tensor(0.0, dtype=torch.float32))
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            if group["amsgrad"]:
                state["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


#: optimizers whose update of an element reads only that element's
#: parameter, gradient and state (and scalars): run on a rank's shards they
#: give the update of the whole tensor. Subclasses are not trusted: they may
#: override ``step``.
ELEMENTWISE_OPTIMIZERS = (torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW, torch.optim.Adamax,
                          torch.optim.NAdam, torch.optim.RAdam, torch.optim.Adagrad,
                          torch.optim.Adadelta, torch.optim.RMSprop, torch.optim.Rprop, torch.optim.ASGD)


def _check_elementwise(opt: torch.optim.Optimizer) -> None:
    if type(opt) not in ELEMENTWISE_OPTIMIZERS:
        raise TypeError(
            f"{type(opt).__name__} cannot run on a mesh: the sharded step updates each rank's shards "
            "on their own, which is the whole tensor's update only for an elementwise optimizer "
            f"({', '.join(c.__name__ for c in ELEMENTWISE_OPTIMIZERS)}); one that reads a whole "
            "tensor (row or column statistics, norms, orthogonalization) would get a per-shard update")


def shard_train_state(params: torch.nn.Module, p_specs: dict, optimizer, mesh) -> TrainState:
    """Place ``params`` onto the mesh per ``p_specs`` (``{path: spec}``) and
    build the optimizer with its state (shared by ``build_train_step`` and
    the module bridge — ONE copy of the ZeRO placement wiring). The
    optimizer must be one of ``ELEMENTWISE_OPTIMIZERS``."""
    params = shard_params(params, mesh, p_specs)
    opt = optimizer(params.parameters())
    _check_elementwise(opt)
    _init_adam_state(opt)
    return TrainState(params, opt, 0)


def step_on_shards(opt: torch.optim.Optimizer) -> None:
    """``opt.step()`` on the local shards: every ``DTensor`` parameter, its
    gradient and its state tensors are swapped for their local tensors for
    the call, so torch's own kernels run (foreach on the card, as for plain
    tensors). A parameter, its gradient and its moments share one placement
    and the update is elementwise, so it is the same update, with none of
    DTensor's dispatch of each operator over every tensor, which took most
    of a 4-card 406M step's host time (``chip_mesh.py --profile``). State a
    step creates is kept as ``DTensor``s in its parameter's placements.
    Any optimizer outside ``ELEMENTWISE_OPTIMIZERS`` is refused."""
    from torch.distributed.tensor import DTensor

    _check_elementwise(opt)
    state, swapped = opt.state, []
    with torch.no_grad():
        for group in opt.param_groups:
            shards = []
            for p in group["params"]:
                if not is_dtensor(p):
                    shards.append(p)
                    continue
                shard = p.to_local()  # without grad: the local tensor itself, so the update lands in p
                shard.grad = None if p.grad is None else p.grad.to_local()
                if p in state:
                    state[shard] = {k: v.to_local() if is_dtensor(v) else v for k, v in state[p].items()}
                shards.append(shard)
            swapped.append((group, group["params"]))
            group["params"] = shards
        try:
            opt.step()
        finally:
            for group, params in swapped:
                for p, shard in zip(params, group["params"]):
                    if shard is p:
                        continue
                    new = state.pop(shard, {})
                    if p not in state:
                        state[p] = {k: DTensor.from_local(v, p.device_mesh, p.placements, run_check=False)
                                    if torch.is_tensor(v) and v.shape == shard.shape else v
                                    for k, v in new.items()}
                    shard.grad = None
                group["params"] = params


def _fused_qkv_view(t: torch.Tensor) -> torch.Tensor:
    """A fused qkv tensor of 3h rows (a parameter or a moment of one) as a
    (3, h, ...) view in the unsharded order, sharing storage with ``t``.
    Under ``tp`` a rank's rows are its heads' ``[q_r; k_r; v_r]``
    (``sharding.qkv_order``): in the (3, h, ...) view they are the r-th
    block of dim 1, so the view is a ``DTensor`` with tp on dim 1, and a
    checkpoint of it restores onto any tp."""
    if not is_dtensor(t):
        return t.view(3, t.shape[0] // 3, *t.shape[1:])
    from torch.distributed.tensor import DTensor, Shard

    mesh, local = t.device_mesh, t.to_local()
    shape = (3, t.shape[0] // 3, *t.shape[1:])
    out = []
    for name, pl in zip(mesh.mesh_dim_names, t.placements):
        if pl.is_shard() and pl.dim == 0 and name != "tp" and axis_size(mesh, name) > 1:
            raise ValueError(f"a fused qkv's rows are split over {name!r}: only tp may split them "
                             "for a checkpoint")
        out.append(Shard(pl.dim + 1) if pl.is_shard() else pl)
    local = local.view(3, local.shape[0] // 3, *local.shape[1:])
    return DTensor.from_local(local, mesh, out, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def train_state_dict(state: TrainState) -> dict:
    """``state`` as a nested dict for a checkpoint
    (``train.integrations.save_pytree_checkpoint``): ``{"params": {path:
    tensor}, "opt_state": {path: the optimizer's per-parameter state},
    "step": int}``, the tensors sharing storage with the state's, so a
    restore into this dict (``load_pytree_checkpoint(..., target=...)``)
    fills the state in place. A fused qkv and its moments appear as (3, h,
    ...) views in the unsharded order (``_fused_qkv_view``), so a
    checkpoint saved at one tp restores at any other. The optimizer's
    hyperparameters come from its factory and are not part of it."""

    def entry(name, p, t):
        if torch.is_tensor(t) and _is_fused_qkv(name) and t.shape == p.shape:
            return _fused_qkv_view(t)
        return t

    named = list(state.params.named_parameters())
    names = {p: n for n, p in named}
    return {
        "params": {n: entry(n, p, p.detach()) for n, p in named},
        "opt_state": {names[p]: {k: entry(names[p], p, v) for k, v in s.items()}
                      for p, s in state.opt_state.state.items()},
        "step": state.step,
    }


def _local_batch(batch, mesh):
    """This rank's ``(dp, fsdp)`` slice of a global batch (a tensor, a numpy
    array, or a dict, list or tuple of them) on the mesh's device."""
    if isinstance(batch, dict):
        return {k: _local_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, list | tuple):
        return type(batch)(_local_batch(v, mesh) for v in batch)
    x = torch.as_tensor(batch)
    x = x[local_slices(x.shape, batch_spec(), mesh)]
    return x if x.is_meta else x.to(mesh.device_type, non_blocking=True)


def global_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of a scalar over every rank of ``mesh``. A tp or ep group's
    members hold equal values, and every member of the token axes (dp,
    fsdp, sp) its mean over an equal share of the tokens, so this is the
    mean over the global batch."""
    if mesh.size() == 1:
        return x
    from torch.distributed.tensor import DTensor, Partial

    total = DTensor.from_local(x.reshape(1), mesh, [Partial()] * mesh.ndim, run_check=False)
    return total.full_tensor()[0] / mesh.size()


def make_step_fn(loss_fn, mesh=None):
    """The step half of ``build_train_step``, reusable with any
    parameter-sharding source: ``step(state, batch) -> (state, loss)`` with
    the loss detached on the device (no host sync). The state carries the
    optimizer (the reference's ``make_step_fn`` takes the optax one)."""
    shards = 1
    if mesh is not None:
        for axis in TOKEN_AXES:
            shards *= axis_size(mesh, axis)

    def step(state: TrainState, batch):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        if mesh is None:
            loss = loss_fn(state.params, batch)
            loss.backward()
            opt.step()
        else:
            loss = loss_fn(state.params, _local_batch(batch, mesh))
            (loss / shards if shards > 1 else loss).backward()
            step_on_shards(opt)
        loss = loss.detach()
        return state._replace(step=state.step + 1), (loss if mesh is None else global_mean(loss, mesh))

    return step


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


def build_train_step(
    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
    optimizer: Callable[[Any], torch.optim.Optimizer],
    mesh: Optional[Any] = None,
):
    """Returns ``(init_fn, step_fn)``.

    ``loss_fn(params, batch) -> scalar`` is differentiated (on a mesh: the
    mean over this rank's slice of the batch, e.g. ``gpt_loss(cfg, p, t,
    mesh=mesh)``). Without a mesh, ``init_fn(params, device=None)`` moves
    the parameters to ``device`` (the card unless the caller asks for the
    CPU); with one, ``init_fn(params)`` shards them onto the mesh under
    ``param_sharding_rules``. Either builds the optimizer from the
    ``optimizer`` factory (``adamw``). ``step_fn(state, batch)`` returns
    ``(state, loss)`` with the loss detached on the device (no host sync).
    """
    if mesh is None:

        def init_fn(params: torch.nn.Module, device=None) -> TrainState:
            params = params.to(resolve_device(device))
            return TrainState(params, optimizer(params.parameters()), 0)

    else:

        def init_fn(params: torch.nn.Module) -> TrainState:
            return shard_train_state(params, param_sharding_rules(params), optimizer, mesh)

    return init_fn, make_step_fn(loss_fn, mesh)
