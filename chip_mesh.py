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

After the ranks end (or alone, with ``--tp-only``), the launcher's own
process drives the tensor-parallel serving engine (``llm.multichip``):
``LLMEngine`` at ``EngineConfig(tp=1, 2, 4)``, each engine starting its own
followers on the next cards. For each model of ``tp_models`` (GPT-J-6B and
GPT-124M in bf16 over 8 slots of prompts that reach 1024 positions, and
both in fp32 on shorter prompts) it serves the same 8 requests (4 greedy, 4
seeded with seed 42) plainly and, in bf16, with ``spec_k=4``, and checks
that the tokens at tp 2 and 4 are tp 1's (exactly in fp32; in bf16 a first
divergence must be a near-tie, the two runs' logprobs of their tokens
there within ``BF16_TIE``), that every rank holds the parameter bytes
reckoned from the shapes (``tp_reckon``) and ``1/tp`` of the pool, and
reports each tp's decode and verify step times (host clock ending in the
step's sync) and one traced decode step on every rank (its device busy
time, NCCL's, the idle share). Last, on GPT-124M fp32 at tp 2, a follower
stopped while the leader's decode step waits in its reduction and then
killed: the step must raise within ``KILL_DEADLINE_S``, and so must the
next one. It prints ``TP`` and a JSON object of it all. ``--tp-models``
serves only the named models, in the order named (the kill check rides
with GPT-124M fp32).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import time
from typing import Optional

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


# -- the tensor-parallel serving engine (llm.multichip), from one process ----

TP_DEGREES = (1, 2, 4)
TP_SLOTS = 8
TP_SPEC_K = 4
#: bf16: the largest gap between two runs' logprobs of their tokens at a
#: first divergence that still counts as a near-tie (chip_smoke.py's
#: BF16_TOP2_MARGIN)
BF16_TIE = 0.1


def tp_models(tiny: bool) -> list:
    """(label, config, init, engine geometry, prompt length range, new
    tokens, speculate): the bf16 models serve 8 slots of prompts that reach
    1024 positions and are timed; the fp32 ones check identity on shorter
    prompts."""
    from ray_tpu_torch.models.gpt import GPTConfig, gpt_init
    from ray_tpu_torch.models.gptj import GPTJ_6B, GPTJConfig, gptj_init

    if tiny:
        geo = dict(max_slots=TP_SLOTS, block_size=4, max_blocks_per_seq=16, num_blocks=TP_SLOTS * 16 + 1,
                   prefill_chunk=16)
        return [("gptj_tiny", GPTJConfig(vocab_size=128, seq_len=64, d_model=64, n_layers=2, n_heads=4,
                                         rotary_dim=8, dtype="float32"), gptj_init, geo, (40, 52), 8, True),
                ("gpt_tiny", GPTConfig(vocab_size=128, seq_len=64, d_model=64, n_layers=2, n_heads=4,
                                       dtype="float32"), gpt_init, geo, (40, 52), 8, True)]
    long = dict(max_slots=TP_SLOTS, block_size=16, max_blocks_per_seq=64, num_blocks=TP_SLOTS * 64 + 1,
                prefill_chunk=256)
    short = dict(max_slots=TP_SLOTS, block_size=16, max_blocks_per_seq=16, num_blocks=TP_SLOTS * 16 + 1,
                 prefill_chunk=256)
    return [("gptj_6b_bf16", GPTJ_6B, gptj_init, long, (960, 992), 32, True),
            ("gpt_124m_bf16", GPTConfig(), gpt_init, long, (960, 992), 32, True),
            ("gptj_6b_fp32", dataclasses.replace(GPTJ_6B, dtype="float32"), gptj_init, short, (192, 224), 32,
             False),
            ("gpt_124m_fp32", GPTConfig(dtype="float32"), gpt_init, short, (192, 224), 32, False)]


def tp_requests(vocab: int, lengths: tuple, new: int) -> list:
    """8 (prompt, sampling) pairs from numpy seed 22: each prompt a random
    segment of 16-64 ids tiled to its length (drafts find matches), the
    first 4 greedy, the rest at temperature 0.8 with seed 42."""
    import numpy as np

    from ray_tpu_torch.llm import SamplingParams

    rng = np.random.RandomState(22)
    out = []
    for i in range(TP_SLOTS):
        seg = rng.randint(0, vocab, rng.randint(16, 65)).tolist()
        n = int(rng.randint(*lengths))
        prompt = (seg * (n // len(seg) + 1))[:n]
        sp = (SamplingParams(max_tokens=new) if i < TP_SLOTS // 2
              else SamplingParams(max_tokens=new, temperature=0.8, seed=42))
        out.append((prompt, sp))
    return out


def tp_reckon(cfg, tp: int) -> tuple:
    """(leader, follower) parameter bytes reckoned from the shapes: each
    rank's column/row slices and replicated parameters, the leader's also
    the final layernorm and the lm head."""
    import torch

    from ray_tpu_torch.llm._tp_worker import LEADER_ONLY, local_shape
    from ray_tpu_torch.models.gpt import GPT, GPTConfig
    from ray_tpu_torch.models.gptj import GPTJ

    model = (GPT if isinstance(cfg, GPTConfig) else GPTJ)(cfg, device="meta")
    lead = follow = 0
    for name, p in model.named_parameters():
        n = math.prod(local_shape(name, p.shape, tp)) * p.element_size()
        lead += n
        follow += 0 if LEADER_ONLY.match(name) else n
    return lead, follow


def tp_serve(eng, requests, dev) -> dict:
    """Serve ``requests`` to the end; tokens, logprobs and step times."""
    import torch

    eng.warmup()
    before = eng.stats()
    reqs = [eng.submit(list(p), sp) for p, sp in requests]
    t0 = time.perf_counter()
    while not all(r.finished for r in reqs):
        eng.step()
    wall = time.perf_counter() - t0
    st = eng.stats()
    d_steps = st["decode_steps"] - before["decode_steps"]
    v_steps = st.get("verify_steps", 0) - before.get("verify_steps", 0)
    out = dict(tokens=[list(r.out) for r in reqs], logprobs=[list(r.out_logprobs) for r in reqs], wall_s=wall,
               decode_steps=d_steps, verify_steps=v_steps,
               decode_ms=(st["decode_s"] - before["decode_s"]) / max(d_steps, 1) * 1e3,
               verify_ms=(st.get("verify_s", 0.0) - before.get("verify_s", 0.0)) / max(v_steps, 1) * 1e3,
               audit=eng.pool.audit()["ok"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def tp_trace(eng, requests, dev) -> dict:
    """One traced decode step with every slot decoding, on every rank: the
    leader's under ``torch.profiler`` here, each follower's in its process
    (``TensorParallelPagedModelRunner.trace_next_step``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm._tp_worker import trace_summary
    from ray_tpu_torch.llm.scheduler import RUNNING

    reqs = [eng.submit(list(p), SamplingParams(max_tokens=min(64, eng.max_model_len - len(p))))
            for p, _ in requests]
    while not all(r.state == RUNNING for r in reqs):
        eng.step()
    eng.step()
    tp = getattr(eng.runner, "tp", 1)
    on_card = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    for _ in range(2):  # the profiler's first use in a process pays its start: keep the second
        if tp > 1:
            eng.runner.trace_next_step()
        if on_card:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            eng.step()
            if on_card:
                torch.cuda.synchronize(dev)
        ranks = [trace_summary(prof, (time.perf_counter() - t0) * 1e3)]
        ranks += eng.runner.group.replies("trace") if tp > 1 else []
    for r in ranks:
        r["idle"] = 1 - r["busy_ms"] / r["wall_ms"] if on_card else None
    for r in reqs:
        eng.cancel(r.id)
    while eng.has_work():
        eng.step()
    return dict(ranks=ranks)


def tp_divergence(ref: dict, got: dict) -> Optional[dict]:
    """The first (request, index) where ``got``'s tokens leave ``ref``'s,
    with the two runs' logprobs of their tokens there; None if equal."""
    for i, (a, b) in enumerate(zip(ref["tokens"], got["tokens"])):
        for j, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return dict(request=i, index=j, tokens=(x, y),
                            gap=abs(ref["logprobs"][i][j] - got["logprobs"][i][j]))
    return None


def tp_kill_mid_step(cfg, params, geo, dev) -> dict:
    """A tp 2 engine whose follower is stopped while the leader's decode
    step waits in its reduction, then killed: the step must raise within
    ``KILL_DEADLINE_S`` of the kill (the leader's watcher aborts the
    group), and so must the next one."""
    import signal
    import threading

    from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams

    eng = LLMEngine(cfg, params, EngineConfig(tp=2, **geo), device=dev)
    out: dict = {}
    try:
        eng.generate([1, 2, 3], SamplingParams(max_tokens=2))
        eng.submit([4, 5, 6], SamplingParams(max_tokens=8))
        eng.step()  # its prefill: the next step is a decode step
        proc = eng.runner.group.procs[0]
        proc.send_signal(signal.SIGSTOP)
        caught = []

        def step():
            try:
                eng.step()
            except RuntimeError as e:
                caught.append((time.monotonic(), str(e)))

        t = threading.Thread(target=step, daemon=True)
        t.start()
        time.sleep(2.0)
        waited = t.is_alive()
        killed = time.monotonic()
        proc.send_signal(signal.SIGKILL)
        t.join(KILL_DEADLINE_S)
        out = dict(waited_for_the_stopped_follower=waited, raised=bool(caught),
                   raise_s=caught[0][0] - killed if caught else None, error=caught[0][1][:200] if caught else None)
        try:
            eng.step()
            out["next_step"] = "returned"
        except RuntimeError as e:
            out["next_step"] = str(e)[:200]
        if not t.is_alive():
            return out
        out["hung"] = True
        return out
    finally:
        if not out.get("hung"):
            eng.shutdown()


#: seconds a step may take to raise after its follower was killed
KILL_DEADLINE_S = 30.0


def tp_main(args) -> dict:
    """The tensor-parallel part (module doc); returns its summary and
    raises when a check fails."""
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda, paged_verify_attention_cuda

    cpu = args.device == "cpu"
    dev = torch.device("cpu" if cpu else "cuda:0")
    if cpu:
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    summary, failures = {}, []
    models = tp_models(args.tiny)
    if args.tp_models:  # these models, in this order
        by_label = {m[0]: m for m in models}
        want = args.tp_models.split(",")
        unknown = sorted(set(want) - set(by_label))
        if unknown:
            raise ValueError(f"--tp-models: no model {unknown}; the models are {list(by_label)}")
        models = [by_label[label] for label in want]
    for label, cfg, init, geo, lengths, new, speculate in models:
        t_model = time.perf_counter()
        params = init(cfg, torch.Generator(device=dev.type).manual_seed(0), dev)
        requests = tp_requests(cfg.vocab_size, lengths, new)
        runs = {}
        for tp in TP_DEGREES:
            if tp > 1 and params.lm_head.weight.device != torch.device("cpu"):
                # from here the leader's card holds its slices alone: the
                # engines take the model from the CPU
                params = params.cpu()
                if not cpu:
                    torch.cuda.empty_cache()
            row = dict(tp=tp)
            for spec in ((0, TP_SPEC_K) if speculate else (0,)):
                if not cpu:
                    torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                eng = LLMEngine(cfg, params, EngineConfig(tp=tp, spec_k=spec, **geo), device=dev)
                built = time.perf_counter() - t0
                try:
                    paged_attention_cuda.launches = paged_verify_attention_cuda.launches = 0
                    served = tp_serve(eng, requests, dev)
                    served["build_s"] = built
                    served["k1_k2_leader"] = (paged_attention_cuda.launches, paged_verify_attention_cuda.launches)
                    if tp > 1:
                        served["followers"] = [dict(k1=r["k1"], k2=r["k2"], steps=r["steps"])
                                               for r in eng.runner.follower_reports()]
                    if spec == 0:
                        led = eng.hbm_ledger()
                        per = led.get("per_device") or {"0": dict(params_bytes=led["params_bytes"],
                                                                  pool_bytes=led["pool_bytes"])}
                        served["per_device"] = {k: dict(params_bytes=v["params_bytes"], pool_bytes=v["pool_bytes"])
                                                for k, v in per.items()}
                        served["pool_bytes"] = led["pool_bytes"]
                        if speculate:  # the timed models
                            served["trace"] = tp_trace(eng, requests, dev)
                    if not cpu:
                        served["peak_gb_leader"] = torch.cuda.max_memory_allocated(dev) / 1e9
                finally:
                    eng.shutdown()
                    del eng
                    if not cpu:
                        torch.cuda.empty_cache()
                row["spec" if spec else "plain"] = served
            runs[tp] = row
            # checks against tp 1
            lead, follow = tp_reckon(cfg, tp)
            per = row["plain"]["per_device"]
            want = [lead] + [follow] * (tp - 1)
            got = [v["params_bytes"] for v in per.values()]
            pool = [v["pool_bytes"] for v in per.values()]
            row["params_reckoned"] = want
            if got != want:
                failures.append(f"{label} tp {tp}: per-rank parameter bytes {got}, reckoned {want}")
            if pool != [runs[1]["plain"]["pool_bytes"] // tp] * tp:
                failures.append(f"{label} tp {tp}: per-rank pool bytes {pool}, tp 1's pool "
                                f"{runs[1]['plain']['pool_bytes']}")
            for kind in row:
                if kind not in ("plain", "spec"):
                    continue
                if not row[kind]["audit"]:
                    failures.append(f"{label} tp {tp} {kind}: the pool's audit failed")
                if tp == 1:
                    continue
                div = tp_divergence(runs[1][kind], row[kind])
                row[kind]["divergence"] = div
                if div is not None and (cfg.dtype == "float32" or div["gap"] > BF16_TIE):
                    failures.append(f"{label} tp {tp} {kind}: tokens leave tp 1's at {div}")
        summary[label] = {tp: {k: ({kk: vv for kk, vv in v.items() if kk not in ("tokens", "logprobs")}
                                   if isinstance(v, dict) else v) for k, v in row.items()}
                          for tp, row in runs.items()}
        summary[label]["seconds"] = time.perf_counter() - t_model
        for tp, row in runs.items():
            p = row["plain"]
            line = (f"TP {label} tp {tp}: decode {p['decode_ms']:.3f} ms over {p['decode_steps']} steps, "
                    f"build {p['build_s']:.1f} s, per-rank params {[v['params_bytes'] for v in p['per_device'].values()]} "
                    f"(reckoned {row['params_reckoned']}), pool {[v['pool_bytes'] for v in p['per_device'].values()]}, "
                    f"leader K1/K2 {p['k1_k2_leader']}, divergence {p.get('divergence')}")
            if "spec" in row:
                sp = row["spec"]
                line += (f"; spec: verify {sp['verify_ms']:.3f} ms over {sp['verify_steps']} steps, decode "
                         f"{sp['decode_ms']:.3f} ms over {sp['decode_steps']}, leader K1/K2 {sp['k1_k2_leader']}, "
                         f"divergence {sp.get('divergence')}")
            if "trace" in p:
                line += "; traced decode step: " + ", ".join(
                    f"rank {i} wall {r['wall_ms']:.3f} busy {r['busy_ms']:.3f} nccl {r['nccl_ms']:.3f} ms idle "
                    + (f"{r['idle']:.4f}" if r["idle"] is not None else "not measured")
                    for i, r in enumerate(p["trace"]["ranks"]))
            print(line, flush=True)
        if label.startswith("gpt_124m_fp32") or label == "gpt_tiny":
            kill = tp_kill_mid_step(cfg, params, geo, dev)
            summary["kill_mid_step"] = kill
            print(f"TP kill mid-step ({label}, tp 2): {kill}", flush=True)
            if not (kill["waited_for_the_stopped_follower"] and kill["raised"]
                    and kill["raise_s"] < KILL_DEADLINE_S and "rank 1" in kill["next_step"]):
                failures.append(f"a follower killed mid-step: {kill}")
        del params
    if failures:
        print("TP " + json.dumps(summary, default=str), flush=True)
        raise AssertionError("; ".join(failures))
    return summary


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
    rcs = []
    if not args.tp_only:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r)] + common, env=env)
                 for r in range(WORLD)]
        try:
            rcs = [p.wait(timeout=TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        print(f"chip_mesh: rank exit codes {rcs}")
    t0 = time.perf_counter()
    summary = tp_main(args)
    print(f"chip_mesh: the tp part took {time.perf_counter() - t0:.1f} s")
    print("TP " + json.dumps(summary, default=str), flush=True)
    rc = 0 if all(rc == 0 for rc in rcs) else 1
    if summary.get("kill_mid_step", {}).get("hung"):
        os._exit(1)  # a step still waits on a dead rank: leave without joining it
    return rc


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--profile", action="store_true", help="rank 0 profiles one more step of each run")
    ap.add_argument("--tp-only", action="store_true", help="only the tensor-parallel serving part")
    ap.add_argument("--tp-models", default="",
                    help="comma-separated labels of tp_models to serve (default: all of them)")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--init")
    args = ap.parse_args()
    if args.rank is None:
        return launch(args)
    rank_main(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
