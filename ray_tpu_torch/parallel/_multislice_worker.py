"""Subprocess body for the REAL multi-process multislice dryrun (port of
``ray_tpu/parallel/_multislice_worker.py``).

Each worker is one rank of ``--procs`` slices of ``--local-devices`` ranks:
it joins one gloo process group through a ``FileStore`` (the counterpart of
the reference's ``jax.distributed.initialize``, and of the upstream trainer
building a cross-host process group in ``python/ray/train/torch/
config.py:47-91``) and takes part in ONE global mesh whose dp axis crosses
the slice boundary — so the dp gradient reduction really rides the
inter-process channel, here gloo over the host.

Run via ``ray_tpu_torch.parallel.multislice.launch_multislice_procs``.
"""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models.gpt import GPTConfig, gpt_init, gpt_loss
    from ray_tpu_torch.parallel.mesh import MeshConfig
    from ray_tpu_torch.parallel.multislice import make_multislice_mesh
    from ray_tpu_torch.parallel.train_step import adamw, build_train_step

    torch.set_num_threads(1)
    n_global = args.procs * args.local_devices
    dist.init_process_group("gloo", store=dist.FileStore(args.store, n_global), rank=args.rank,
                            world_size=n_global)
    try:
        # contiguous slice partitioning puts the slice boundary on the
        # boundary of each slice's ranks: dp's major dim enumerates slices,
        # tp stays within one
        tp = 2 if args.local_devices % 2 == 0 else 1
        mesh = make_multislice_mesh(MeshConfig(dp=n_global // tp, fsdp=1, tp=tp, sp=1),
                                    num_slices=args.procs, devices="cpu")
        cfg = GPTConfig(vocab_size=512, seq_len=64, d_model=128, n_layers=2, n_heads=4)

        def loss_fn(params, batch):
            return gpt_loss(cfg, params, batch, mesh)

        init_fn, step_fn = build_train_step(loss_fn, adamw(1e-3), mesh)
        state = init_fn(gpt_init(cfg, torch.Generator().manual_seed(0), device="cpu"))  # same seed every rank
        rng = np.random.default_rng(0)  # same batch every rank
        batch = rng.integers(0, cfg.vocab_size, size=(n_global // tp * 2, cfg.seq_len + 1))
        losses = []
        for _ in range(args.steps):
            state, loss = step_fn(state, batch)
            losses.append(loss.item())  # the global mean: the same on every rank
    finally:
        dist.destroy_process_group()
    assert all(np.isfinite(l) and l > 0 for l in losses), losses
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
    print(f"MSPROC rank={args.rank} losses={losses}", flush=True)


if __name__ == "__main__":
    main()
