"""Any ``nn.Module`` on the sharded step (the port of
``ray_tpu/train/integrations/flax_bridge.py``, renamed by design as
``JaxTrainer`` is ``TorchTrainer``: the reference bridges flax/linen
modules, the port's counterpart is torch's own module type).

``build_module_train_step`` takes a module and a loss and returns the same
``(init_fn, step_fn)`` contract ``parallel.train_step.build_train_step``
produces — forward, backward and optimizer with ZeRO-style sharding — so a
module drops into ``TorchTrainer`` loops unchanged.

Sharding: a module's parameter paths don't follow ``models.gpt``'s, so
specs come from ``module_sharding_rules`` — a size-aware heuristic (shard
each large parameter's LARGEST axis over ``fsdp``, replicate small ones)
with an ``overrides`` escape hatch of regex → spec. Each rank computes with
the whole weights, gathered for the call (``sharding.apply_gathered``).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Optional

import torch


def module_sharding_rules(
    params: torch.nn.Module,
    min_shard_size: int = 2**16,
    overrides: Optional[list[tuple[str, tuple]]] = None,
) -> dict:
    """``{parameter path: spec}`` for any module.

    * a path matching an ``overrides`` regex takes that spec verbatim;
    * parameters with ``numel >= min_shard_size`` shard their largest axis
      over ``fsdp`` (ZeRO-style: weights and their Adam moments scatter);
    * everything else replicates (biases, scales, small embeddings).
    """
    overrides = overrides or []

    def one(path, p):
        for pattern, spec in overrides:
            if re.search(pattern, path):
                return tuple(spec)
        if p.dim() == 0 or p.numel() < min_shard_size:
            return ()
        axis = max(range(p.dim()), key=lambda i: p.shape[i])
        spec = [None] * p.dim()
        spec[axis] = "fsdp"
        return tuple(spec)

    return {path: one(path, p) for path, p in params.named_parameters()}


def build_module_train_step(
    module: torch.nn.Module,
    loss_fn: Callable[[Callable, torch.nn.Module, Any], torch.Tensor],
    optimizer: Callable[[Any], torch.optim.Optimizer],
    mesh,
    sample_batch: Any,
    min_shard_size: int = 2**16,
    sharding_overrides: Optional[list[tuple[str, tuple]]] = None,
):
    """(init_fn, step_fn) for a module on a device mesh.

    Args:
      module: any ``torch.nn.Module`` (lazy modules are materialized by one
        forward on ``sample_batch``).
      loss_fn: ``loss_fn(apply_fn, params, batch) -> scalar`` — the user
        calls ``apply_fn(params, *inputs)`` where plain torch calls
        ``module(*inputs)``; ``batch`` is this rank's slice.
      optimizer: a factory ``params -> torch.optim.Optimizer``
        (``parallel.adamw``, or e.g. ``lambda ps: torch.optim.Adam(ps)``);
        an elementwise one (``parallel.train_step.ELEMENTWISE_OPTIMIZERS``),
        since each rank updates its own shards.
      mesh: a ``parallel.make_mesh`` mesh with (at least) an ``fsdp`` axis.
      sample_batch: one batch (host values), used only to materialize a
        lazy module's shapes.

    Returns:
      ``init_fn() -> TrainState`` (the parameters sharded onto the mesh with
      the heuristic specs) and ``step_fn(state, batch) -> (state, loss)``
      (batch sliced over dp+fsdp, profiled).
    """
    from ray_tpu_torch.parallel.sharding import apply_gathered
    from ray_tpu_torch.parallel.train_step import make_step_fn, profile_step_fn, shard_train_state

    def apply_fn(params, *args, **kwargs):
        return apply_gathered(params, lambda m, *a, **kw: m(*a, **kw), *args, **kwargs)

    def model_loss(params, batch):
        return loss_fn(apply_fn, params, batch)

    def init_fn():
        from torch.nn.parameter import is_lazy

        if any(is_lazy(p) for p in module.parameters()):
            with torch.no_grad():
                module(torch.utils._pytree.tree_map(torch.as_tensor, sample_batch))
        p_specs = module_sharding_rules(module, min_shard_size=min_shard_size,
                                        overrides=sharding_overrides)
        # placement + step wiring are the SAME code build_train_step uses —
        # only the sharding-rule source differs
        return shard_train_state(module, p_specs, optimizer, mesh)

    # profiled: per-step host time + retrace detection ride the train
    # plane's metrics (device_step_seconds{site=train_step}); the raw step
    # stays reachable via step_fn.__wrapped__
    return init_fn, profile_step_fn(make_step_fn(model_loss, mesh))
