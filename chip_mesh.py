#!/usr/bin/env python3
"""The port's SPMD training on a mesh of several cards, one process per card.

    python3 chip_mesh.py                       # 4 ranks on 4 cards (NCCL)
    python3 chip_mesh.py --device cpu --tiny   # 4 gloo ranks on the CPU, a tiny GPT
    python3 chip_mesh.py --profile             # and rank 0's trace of one more step

Starts ``WORLD`` processes, one per rank, joined by one process group at
``tcp://127.0.0.1:<free port>``. Every rank:

1. runs the one-device step (``build_train_step`` without a mesh) of the
   GPT on its own card from the same weights (seed 0) and batch (numpy
   seed 13) — the reference the meshes are held against — and again on
   rank 0's slice of the batch alone (a ``WORLD``-th of the sequences):
   its time is a rank's share of the work, and its parameters are what a
   mesh that lost its batch reduction would hold on rank 0;
2. for each mesh of ``MESHES`` (dp 4; dp 2 x fsdp 2; fsdp 4; fsdp 2 x tp
   2; sp 4 and sp 2 x dp 2, where attention is ring attention over sp)
   builds ``make_mesh``, shards the same weights, takes ``STEPS`` steps
   and checks that every rank reports the same loss, that it agrees with
   the one-device step's within ``TOL`` relative (bf16 activations: the
   ranks' partial sums round in another order; the bf16 limit is 12x the
   largest gap of the sound runs on 4 H100s, 8.3e-5), that every rank
   holds the same parameters (a bit-sum of each whole parameter), and that
   they lie nearer the one-device step's than the slice-alone step's do
   (``NEAR`` of that distance); times the steps after the first (host
   clock ending in the loss's sync) and reads the peak memory;
3. does 1 and 2 for the mixture-of-experts GPT on ``MOE_MESHES`` (ep 2 x
   dp 2, ep 4, ep 2 x tp 2) in fp32, so that no bf16 rounding tie flips a
   top-k choice and the fp32 limit holds, then times the one-device step
   and each mesh's in bf16;
4. checks ``mesh_allreduce`` of integer-valued fp32 over the first mesh
   axis against torch's own reductions, exactly, for each ``ReduceOp``;
5. runs ``pipeline_apply`` over a ``pp`` axis of every rank (send and
   receive between neighbours) against the layers applied in sequence,
   forward and gradients, within ``TOL[float32]``.

The full run uses the 406M configuration of bench.py (vocab 50304, seq
1024, d 1024, 24 layers, 16 heads, remat "attn", bf16) at a global batch of
32 sequences, and ``chip_smoke.py`` phase 27 (b)'s MoE GPT-124M (8 experts
top-2, capacity 1.25, remat "full") at 16. Rank 0 prints a JSON summary as
its last line; the launcher exits non-zero when any rank fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

TOL = {"float32": 2e-5, "bfloat16": 1e-3}
NEAR = 0.5
WORLD = 4
AXES = ("dp", "fsdp", "ep", "sp", "tp")
MESHES = {"dp4": dict(dp=4), "dp2_fsdp2": dict(dp=2, fsdp=2), "fsdp4": dict(fsdp=4),
          "fsdp2_tp2": dict(fsdp=2, tp=2), "sp4": dict(sp=4), "sp2_dp2": dict(sp=2, dp=2)}
MOE_MESHES = {"ep2_dp2": dict(ep=2, dp=2), "ep4": dict(ep=4), "ep2_tp2": dict(ep=2, tp=2)}
BATCH = 32
MOE_BATCH = 16
STEPS = 4
TIMEOUT = 900.0


def model_config(tiny: bool):
    from ray_tpu_torch.models.gpt import GPTConfig

    if tiny:
        return GPTConfig(vocab_size=256, seq_len=64, d_model=64, n_layers=2, n_heads=4, dtype="float32",
                         attn_impl="flash")
    return GPTConfig(vocab_size=50_304, seq_len=1024, d_model=1024, n_layers=24, n_heads=16,
                     remat_policy="attn", ce_chunks=1)


def moe_config(tiny: bool, dtype: str):
    from ray_tpu_torch.models.gpt import GPTConfig

    if tiny:
        return GPTConfig(vocab_size=256, seq_len=64, d_model=64, n_layers=2, n_heads=4, dtype=dtype,
                         attn_impl="flash", n_experts=4)
    return GPTConfig(n_experts=8, dtype=dtype)  # GPT-124M, 8 experts top-2, capacity 1.25, remat "full"


def profile_line(prof, total: float, enqueued: float) -> str:
    """One traced step: its host time, the host ops that took most, and on
    the card the device timeline (``ProfilerActivity.CUDA``): the union of
    the kernels' intervals, compute and NCCL apart, against the step."""
    from torch.autograd import DeviceType

    def union(spans) -> float:
        busy, end = 0.0, float("-inf")
        for a, b in sorted(spans):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return busy / 1e3  # us -> ms

    kernels = [(e.time_range.start, e.time_range.end, "nccl" in e.name.lower()) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
    line = (f"step {total:.3f} ms (traced), returned after {enqueued:.3f} ms; top host ops by self time: "
            + "; ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}" for e in ops))
    if not kernels:
        return line + "; device timeline: not measured (no device events)"
    busy = union([(a, b) for a, b, _ in kernels])
    comm = union([(a, b) for a, b, c in kernels if c])
    compute = union([(a, b) for a, b, c in kernels if not c])
    span = (max(b for _, b, _ in kernels) - min(a for a, _, _ in kernels)) / 1e3
    return (line + f"; device: {len(kernels)} kernels, busy {busy:.3f} ms (compute {compute:.3f}, "
            f"nccl {comm:.3f}, both at once {compute + comm - busy:.3f}) over a span of {span:.3f} ms, "
            f"idle {1 - busy / total:.4f} of the step")


def rank_main(args) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.collective import ReduceOp, mesh_allreduce
    from ray_tpu_torch.models.gpt import gpt_init, gpt_loss
    from ray_tpu_torch.parallel import MeshConfig, adamw, build_train_step, make_mesh
    from ray_tpu_torch.parallel.mesh import mesh_from_ranks
    from ray_tpu_torch.parallel.pipeline import pipeline_apply
    from ray_tpu_torch.parallel.sharding import full_value, global_put

    cpu = args.device == "cpu"
    if cpu:
        torch.set_num_threads(1)  # the ranks share the host's cores
    else:
        torch.cuda.set_device(args.rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cpu" if cpu else f"cuda:{args.rank}")
    dist.init_process_group("gloo" if cpu else "nccl", init_method=args.init, rank=args.rank,
                            world_size=WORLD)
    cfg = model_config(args.tiny)

    def sync():
        if not cpu:
            torch.cuda.synchronize(dev)

    def params(cfg):
        gen = torch.Generator(device=dev.type).manual_seed(0)
        return gpt_init(cfg, gen, device=dev)

    def run(step_fn, state, label, batch):
        """``STEPS`` steps: (losses, ms, state). With ``--profile`` every
        rank then takes one more step, which rank 0 traces: its host time,
        top host ops, and on the card the device timeline's busy time
        (the union of the kernels' intervals, compute and NCCL apart) and
        idle share of the step."""
        losses, ms = [], []
        for _ in range(STEPS):
            sync()
            t0 = time.perf_counter()
            state, loss = step_fn(state, batch)
            losses.append(loss.item())
            ms.append((time.perf_counter() - t0) * 1e3)
        if args.profile:
            import contextlib

            from torch.profiler import ProfilerActivity, profile

            sync()
            acts = [ProfilerActivity.CPU] + ([] if cpu else [ProfilerActivity.CUDA])
            with profile(activities=acts) if args.rank == 0 else contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                state, loss = step_fn(state, batch)
                enqueued = (time.perf_counter() - t0) * 1e3
                loss.item()
                total = (time.perf_counter() - t0) * 1e3
            if args.rank == 0:
                print(f"PROFILE {label}: {profile_line(prof, total, enqueued)}", flush=True)
        return losses, ms, state

    def whole(state):
        """(name, whole parameter in the unsharded layout) for each
        parameter; a mesh's are gathered."""
        for n, p in state.params.named_parameters():
            yield n, full_value(p, fused_qkv="attn_qkv" in n).float()

    def tokens_of(cfg, batch):
        rng = np.random.RandomState(13)
        return torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, cfg.seq_len + 1))).to(dev)

    def mesh_of(axes):
        return make_mesh(MeshConfig(**{a: axes.get(a, 1) for a in AXES}), devices=dev.type)

    def memory_reset():
        if not cpu:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def peak_gb():
        return None if cpu else torch.cuda.max_memory_allocated(dev) / 1e9

    def config_of(cfg):
        return {k: getattr(cfg, k) for k in ("vocab_size", "seq_len", "d_model", "n_layers", "n_heads", "dtype",
                                             "n_experts")}

    def parity(group, cfg, tokens, meshes, failures) -> dict:
        """1 and 2: the one-device step, the slice alone, then each mesh
        against them."""
        tol = TOL[cfg.dtype]
        res = {"config": config_of(cfg), "batch": tokens.shape[0]}
        init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(cfg, p, t), adamw(1e-4))
        ref = {}
        for name, batch in (("one_device", tokens), ("one_device_slice", tokens[:tokens.shape[0] // WORLD])):
            memory_reset()
            losses, ms, state = run(step_fn, init_fn(params(cfg), dev), f"{group} {name}", batch)
            res[name] = dict(batch=batch.shape[0], losses=losses, ms=ms, peak_gb=peak_gb())
            ref[name] = {n: v.clone() for n, v in whole(state)}
            del state
        plain = res["one_device"]["losses"]
        lost = sum((ref["one_device_slice"][n] - v).double().square().sum() for n, v in ref["one_device"].items())
        res["one_device_slice"]["distance"] = lost = lost.sqrt().item()
        del ref["one_device_slice"]
        for name, axes in meshes.items():
            mesh = mesh_of(axes)
            mcfg = cfg if axes.get("sp", 1) == 1 else dataclasses.replace(cfg, attn_impl="auto")  # ring over sp
            init_m, step_m = build_train_step(lambda p, t, c=mcfg, m=mesh: gpt_loss(c, p, t, m), adamw(1e-4), mesh)
            memory_reset()
            losses, ms, state = run(step_m, init_m(params(cfg)), f"{group} {name}", tokens)
            peak = peak_gb()
            sq = torch.zeros((), dtype=torch.float64, device=dev)
            bits = torch.zeros((), dtype=torch.int64, device=dev)
            for n, v in whole(state):
                sq += (v - ref["one_device"][n]).double().square().sum()
                bits += v.view(torch.int32).sum(dtype=torch.int64)
            del state
            every = [None] * WORLD
            dist.all_gather_object(every, (losses, bits.item()))
            gap = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
            res[name] = dict(losses=losses, ms=ms, gap=gap, same_on_every_rank=all(e == every[0] for e in every),
                             distance=sq.sqrt().item(), peak_gb=peak)
            if not res[name]["same_on_every_rank"] or gap > tol:
                failures.append(f"{name}: (losses, parameter bit-sum) {every} against the one-device step's "
                                f"losses {plain} (limit {tol})")
            if res[name]["distance"] > NEAR * lost:
                failures.append(f"{name}: parameters {res[name]['distance']:.6g} from the one-device step's, "
                                f"the slice alone's {lost:.6g} (limit {NEAR} of it)")
        return res

    def timing(group, cfg, tokens, meshes) -> dict:
        """3's times: the one-device step and each mesh's, no parity."""
        res = {"config": config_of(cfg), "batch": tokens.shape[0]}
        init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(cfg, p, t), adamw(1e-4))
        memory_reset()
        losses, ms, state = run(step_fn, init_fn(params(cfg), dev), f"{group} one_device", tokens)
        res["one_device"] = dict(losses=losses, ms=ms, peak_gb=peak_gb())
        del state
        for name, axes in meshes.items():
            mesh = mesh_of(axes)
            init_m, step_m = build_train_step(lambda p, t, m=mesh: gpt_loss(cfg, p, t, m), adamw(1e-4), mesh)
            memory_reset()
            losses, ms, state = run(step_m, init_m(params(cfg)), f"{group} {name}", tokens)
            res[name] = dict(losses=losses, ms=ms, peak_gb=peak_gb())
            del state
        return res

    out = {"device": "cpu" if cpu else torch.cuda.get_device_name(dev), "world": WORLD}
    failures = []
    out["gpt_406m"] = parity("gpt_406m", cfg, tokens_of(cfg, BATCH), MESHES, failures)
    moe32 = moe_config(args.tiny, "float32")
    out["moe_fp32"] = parity("moe_fp32", moe32, tokens_of(moe32, MOE_BATCH), MOE_MESHES, failures)
    moe16 = moe_config(args.tiny, "bfloat16")
    out["moe_bf16"] = timing("moe_bf16", moe16, tokens_of(moe16, MOE_BATCH), MOE_MESHES)

    mesh = make_mesh(MeshConfig(), devices=dev.type)
    gen = torch.Generator(device=dev.type).manual_seed(34)
    x = torch.randint(1, 3, (4 * WORLD, 1024), generator=gen, device=dev).float()
    x = x * torch.where(torch.rand(x.shape, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    want = {ReduceOp.SUM: x.sum(0), ReduceOp.PRODUCT: x.prod(0), ReduceOp.MIN: x.amin(0), ReduceOp.MAX: x.amax(0)}
    out["mesh_allreduce_exact"] = {op.name: bool(torch.equal(mesh_allreduce(x, mesh, op=op), want[op]))
                                   for op in ReduceOp}
    if not all(out["mesh_allreduce_exact"].values()):
        failures.append(f"mesh_allreduce: {out['mesh_allreduce_exact']}")

    pp_mesh = mesh_from_ranks(dev.type, list(range(WORLD)), ("pp",))
    d, n_layers = 256, 4 * WORLD
    g = torch.Generator().manual_seed(7)
    stack = {"w": torch.randn(n_layers, d, d, generator=g) * d**-0.5, "b": torch.zeros(n_layers, d)}
    xs = torch.randn(16, d, generator=g).to(dev)

    def stage_fn(p, h):
        for w, b in zip(p["w"], p["b"]):
            h = torch.tanh(h @ w + b)
        return h

    seq_params = {k: v.to(dev, copy=True).requires_grad_() for k, v in stack.items()}
    seq = stage_fn(seq_params, xs)
    (seq**2).mean().backward()
    pp_params = {k: global_put(v.to(dev, copy=True), pp_mesh, ("pp",)).requires_grad_() for k, v in stack.items()}
    sync()
    t0 = time.perf_counter()
    pipe = pipeline_apply(stage_fn, pp_params, xs, pp_mesh, n_layers, microbatches=4, batch_axes=())
    (pipe**2).mean().backward()
    sync()
    pipe_ms = (time.perf_counter() - t0) * 1e3
    out_gap = (pipe - seq).abs().max().item()
    grad_gap = max((pp_params[k].grad.full_tensor() - seq_params[k].grad).abs().max().item() for k in stack)
    out["pipeline"] = dict(pp=WORLD, microbatches=4, out_gap=out_gap, grad_gap=grad_gap, ms=pipe_ms)
    if out_gap > TOL["float32"] or grad_gap > TOL["float32"]:
        failures.append(f"pipeline: output gap {out_gap}, gradient gap {grad_gap}")
    dist.destroy_process_group()
    if args.rank == 0:
        print(json.dumps(out), flush=True)
    if failures:
        raise AssertionError("; ".join(failures))


def launch(args) -> int:
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
            print(f"chip_mesh: {WORLD} CUDA devices needed", file=sys.stderr)
            return 1
        cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True).stdout.strip()
        print(f"chip_mesh: cards {cards.splitlines()}", flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    common = (["--device", args.device, "--init", f"tcp://127.0.0.1:{port}"] + (["--tiny"] if args.tiny else [])
              + (["--profile"] if args.profile else []))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (os.path.dirname(os.path.abspath(__file__)),
                                                    env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r)] + common, env=env)
             for r in range(WORLD)]
    try:
        rcs = [p.wait(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    print(f"chip_mesh: rank exit codes {rcs}")
    return 0 if all(rc == 0 for rc in rcs) else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--profile", action="store_true", help="rank 0 profiles one more step of each run")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--init")
    args = ap.parse_args()
    if args.rank is None:
        return launch(args)
    rank_main(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
