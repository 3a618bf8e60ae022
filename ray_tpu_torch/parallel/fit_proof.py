"""Fit proof: rank 0 of an fsdp-``n`` train step, built (and on the card
measured) in one process (port of ``ray_tpu/parallel/fit_proof.py``).

The reference AOT-compiles the step from abstract values on a virtual
8-device mesh and reads XLA's memory estimate. The port builds rank 0 of
the same step under torch's fake process group
(``torch.testing._internal.distributed.fake_pg``: a world of ``n`` ranks
whose collectives return at once and move no data):

* on the meta device nothing is allocated: the parameters are sharded, the
  optimizer's state built and one step run on meta tensors, which proves
  the step's shapes and counts ``argument_bytes`` exactly from the local
  shards of the parameters and of Adam's moments;
* on the card the model is drawn from a seed and one step runs for real on
  rank 0's batch slice: ``per_chip_bytes`` is ``torch.cuda
  .max_memory_allocated`` over that step, and the report says whether it
  fits the card's memory. The fake collectives leave the gathered weights
  unwritten, so the step's loss means nothing.

The fake group is the process's default group for the duration; a process
that already has one cannot start it, so ``fit_report`` refuses then.
"""

from __future__ import annotations


def _local_nbytes(tensors) -> int:
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes for t in tensors)


def fit_report(cfg, n_devices: int = 8, batch: int = 8, model: str = "gpt", device=None) -> dict:
    """Rank 0 of ``cfg``'s train step under fsdp-``n_devices``, with the
    global batch ``batch``. ``model`` picks the architecture: "gpt"
    (``models.gpt``) or "gptj" (``models.gptj``), each gathering its
    parameters block by block. ``device``: None
    (the card: measured) or ``"meta"`` (built, nothing allocated)."""
    import math

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ray_tpu_torch.device import resolve_device
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu_torch.parallel.train_step import adamw, build_train_step

    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("fit_report starts a fake process group of its own: destroy the "
                           "process's default group first")
    if model == "gptj":
        from ray_tpu_torch.models.gptj import GPTJ as Model
        from ray_tpu_torch.models.gptj import gptj_init as init_model
        from ray_tpu_torch.models.gptj import gptj_loss as model_loss
    else:
        from ray_tpu_torch.models.gpt import GPT as Model
        from ray_tpu_torch.models.gpt import gpt_init as init_model
        from ray_tpu_torch.models.gpt import gpt_loss as model_loss

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_devices)
    try:
        mesh = make_mesh(MeshConfig(dp=1, fsdp=n_devices, tp=1, sp=1),
                         devices="cpu" if meta else dev.type)

        def loss_fn(params, tokens):
            return model_loss(cfg, params, tokens, mesh)

        init_fn, step_fn = build_train_step(loss_fn, adamw(1e-4), mesh)
        if meta:
            params = Model(cfg, device="meta")
            tokens = torch.zeros(batch, cfg.seq_len + 1, dtype=torch.long, device="meta")
        else:
            params = init_model(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
            gen = torch.Generator(device=dev).manual_seed(1)
            tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.seq_len + 1), generator=gen, device=dev)
        n_params = sum(math.prod(p.shape) for p in params.parameters())
        state = init_fn(params)
        del params
        # Adam's moments; its step counts are host scalars
        moments = [t for s in state.opt_state.state.values() for t in s.values() if isinstance(t, DTensor)]
        args = _local_nbytes(state.params.parameters()) + _local_nbytes(moments)
        if meta:
            # on meta a data-dependent shape (the fused CE's masked target
            # rows) has no answer: take every element as selected
            from torch.fx.experimental import _config as fx_config

            with fx_config.patch(meta_nonzero_assume_all_nonzero=True):
                state, loss = step_fn(state, tokens)
        else:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            state, loss = step_fn(state, tokens)
        out = {
            "model_params": n_params,
            "n_devices": n_devices,
            "batch": batch,
            "seq_len": cfg.seq_len,
            "remat_policy": cfg.remat_policy,
            "compiles": tuple(loss.shape) == (),
            "argument_bytes": args,
        }
        if not meta:
            torch.cuda.synchronize(dev)
            per_chip = torch.cuda.max_memory_allocated(dev)
            total = torch.cuda.get_device_properties(dev).total_memory
            out.update(per_chip_bytes=per_chip, per_chip_gib=round(per_chip / (1 << 30), 2),
                       card_memory_bytes=total, fits_card_memory=per_chip < total)
        return out
    finally:
        dist.destroy_process_group()


def gptj_6b_fit_report(
    n_devices: int = 8,
    batch: int = 8,
    remat_policy: str = "full",
    seq_len: int = 2048,
    device=None,
) -> dict:
    """Fit proof of the GPT-J-6B architecture (``models.gptj``: rotary,
    parallel residual, no-bias projections, untied biased head)."""
    from ray_tpu_torch.models.gptj import GPTJConfig

    cfg = GPTJConfig(vocab_size=50_432, seq_len=seq_len, remat_policy=remat_policy)
    out = fit_report(cfg, n_devices=n_devices, batch=batch, model="gptj", device=device)
    out["architecture"] = "gptj"
    return out


def main() -> None:  # pragma: no cover - a command-line entry point
    import json

    print(json.dumps(gptj_6b_fit_report(device="meta")))


if __name__ == "__main__":  # pragma: no cover
    main()
