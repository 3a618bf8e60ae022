#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one NVIDIA H100

Builds the port's CUDA kernels from the sources in the checkout, holds each
against its plain PyTorch version at the serving path's shapes, times it,
and drives the port's main path — the paged-KV GPT-J serving engine at the
full GPT-J-6B width (28 layers, bf16, random weights from a seed) — through
the entry points a user calls. Phases, each of which raises on failure:

1. device: name, compute capability, power limit;
2. build: the ``-Xptxas -v`` register / shared-memory report;
3. K1 (paged decode attention) vs its plain version, fp32 and bf16;
4. K1 timing beside the plain version, the library call and the bound;
5. fp32 identity: a full-width, 2-layer engine is token-identical to the
   dense ``gptj_decode``;
6. GPT-J-6B serve: ``run_loop`` in a thread, requests from several threads
   through ``stream_tokens``, prefix-cache hits, a copy-on-write fork,
   greedy and seeded-sampled requests; checks the pool audit, the kernel's
   launch count and every greedy token against the dense forward;
7. decode profile: device busy time of a steady 8-slot decode step by
   kernel, against its wall time without the profiler, and the host time
   of the step's Gumbel noise.

The last line is ``{"ok": true, "device": {...}}``; the line before it has
the card's name and power limit, the one before that the kernels' record.
Exits non-zero, printing no result, when there is no CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm.model_runner import _row_noise
from ray_tpu_torch.llm.scheduler import RUNNING
from ray_tpu_torch.models.gptj import GPTJ_6B, GPTJConfig, gptj_decode, gptj_forward, gptj_init
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops.paged_attention import paged_attention, paged_attention_cuda

# H100 SXM data-sheet peaks (dense): HBM bytes/s and operations/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# slice shapes: GPT-J-6B decode at 8 slots, block 16, 128-entry tables
S, H, D, BS, T = 8, 16, 256, 16, 128
NB = S * T + 1  # the serve phase's pool: 1025 blocks, block 0 the trash block

# K1 vs plain: the fp32 pair differs only in summation order (the
# reference's Pallas-vs-XLA tolerance); in bf16 both round one fp32 result
# to bf16, and a different summation order can move it by one bf16 step
# (2^-8 relative) at magnitudes up to ~1
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}

# greedy check of the bf16 serve: an engine token must be the dense
# forward's argmax unless the dense forward's top-2 logits lie within this
# margin of each other (bf16 rounding at other places in the two paths
# moves logits by a few hundredths after 28 layers)
BF16_TOP2_MARGIN = 0.1


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_inputs(dtype, lengths, seed):
    """Random q/pools and per-slot tables of distinct live blocks, padded
    with the trash block past each slot's length."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lengths = lengths.cuda()
    q = torch.randn(S, H, D, device="cuda", generator=g).to(dtype)
    kp = torch.randn(NB, H, BS, D, device="cuda", generator=g).to(dtype)
    vp = torch.randn(NB, H, BS, D, device="cuda", generator=g).to(dtype)
    tables = (torch.randperm(NB - 1, device="cuda", generator=g)[: S * T] + 1).view(S, T)
    live = torch.arange(T, device="cuda")[None, :] < ((lengths + BS - 1) // BS)[:, None]
    tables = torch.where(live, tables, 0).int().contiguous()
    return q, kp, vp, tables, lengths.int()


def k1_bound_ms(dtype, lengths) -> float:
    """Least time for one call: each live K/V row, q, the live table entries
    and the lengths read once, out written once; 4*D operations per row."""
    esize = torch.finfo(dtype).bits // 8
    n = int(lengths.sum())
    live_entries = int(((lengths + BS - 1) // BS).sum())
    nbytes = 2 * n * H * D * esize + 2 * S * H * D * esize + 4 * (live_entries + S)
    ops = 4 * n * H * D
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]) * 1e3


def check_k1() -> float:
    """Phase 3: returns the bf16 max abs error over the compared rows."""
    rng = np.random.RandomState(0)
    lens = torch.tensor([1, 15, 16, 17, 2048, *rng.randint(1, T * BS + 1, 2), 0])
    compared = lens > 0  # the 0-length row is only required to be finite
    err_bf16 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        args = k1_inputs(dtype, lens, seed=1)
        ref = paged_attention(*args, impl="torch")
        out = paged_attention(*args, impl="cuda")
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"K1 {dtype}: non-finite output")
        err = (out.float() - ref.float()).abs()[compared.cuda()].max().item()
        print(f"K1 {dtype} lengths={lens.tolist()} max_abs_err={err:.3g} tol={TOL[dtype]}")
        if not err <= TOL[dtype]:
            raise AssertionError(f"K1 {dtype}: max abs error {err} > {TOL[dtype]}")
        if dtype == torch.bfloat16:
            err_bf16 = err
    return err_bf16


def time_k1() -> dict:
    """Phase 4 at the decode shapes: 8 slots x 1024 context, bf16."""
    dtype = torch.bfloat16
    lens = torch.full((S,), 1024)
    q, kp, vp, tables, lengths = k1_inputs(dtype, lens, seed=2)
    ms = cuda_ms(lambda: paged_attention(q, kp, vp, tables, lengths, impl="cuda"), 200)
    plain_ms = cuda_ms(lambda: paged_attention(q, kp, vp, tables, lengths, impl="torch"), 20)
    # library yardstick: SDPA over K/V gathered to dense beforehand (the
    # gather is NOT timed) with the length mask
    live = int(((lens.max() + BS - 1) // BS).item())
    idx = tables[:, :live].long()
    kd = kp[idx].transpose(1, 2).reshape(S, H, live * BS, D)
    vd = vp[idx].transpose(1, 2).reshape(S, H, live * BS, D)
    mask = (torch.arange(live * BS, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask), 200)
    rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=k1_bound_ms(dtype, lens))
    print(
        f"K1 timing bf16 S={S} H={H} D={D} BS={BS} len=1024: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (SDPA on pre-gathered K/V, gather excluded) "
        f"{library_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms (bytes)"
    )
    return rec


def fp32_identity() -> None:
    """Phase 5: full width, 2 layers, fp32 — engine greedy == dense decode."""
    cfg = GPTJConfig(n_layers=2, dtype="float32")
    params = gptj_init(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    eng = LLMEngine(
        cfg, params,
        EngineConfig(max_slots=4, block_size=16, max_blocks_per_seq=32, num_blocks=129,
                     prefill_chunk=64),
    )
    rng = np.random.RandomState(1)
    head = list(rng.randint(0, cfg.vocab_size, 40))
    prompts = [
        head + list(rng.randint(0, cfg.vocab_size, 37)),
        list(rng.randint(0, cfg.vocab_size, 130)),
        head[:36] + list(rng.randint(0, cfg.vocab_size, 20)),  # diverges mid-block
        list(rng.randint(0, cfg.vocab_size, 9)),
    ]
    n_new = 16
    first = eng.submit(prompts[0], SamplingParams(max_tokens=n_new))
    while not first.finished:
        eng.step()
    reqs = [first] + [eng.submit(p, SamplingParams(max_tokens=n_new)) for p in prompts[1:]]
    while not all(r.finished for r in reqs):
        eng.step()
    for p, r in zip(prompts, reqs):
        ref = gptj_decode(cfg, params, torch.tensor([p], device="cuda"), n_new)[0, len(p):]
        if r.out != ref.tolist():
            raise AssertionError(f"fp32 engine {r.out} != dense decode {ref.tolist()}")
    pc = eng.prefix_cache.stats()
    if not (eng.pool.audit()["ok"] and eng.prefix_cache.audit()["ok"]):
        raise AssertionError("fp32 engine: pool or prefix-cache audit failed")
    print(
        f"fp32 identity: {len(reqs)} requests x {n_new} tokens equal dense gptj_decode "
        f"(prefix hit tokens {pc['hit_tokens']}, cow forks {pc['cow_forks']})"
    )


def serve_6b(card: str) -> dict:
    """Phase 6: GPT-J-6B, bf16, served by run_loop to several client threads."""
    cfg = GPTJ_6B
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = gptj_init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    print(f"GPT-J-6B random init on the card: {time.perf_counter() - t0:.1f} s")
    eng = LLMEngine(
        cfg, params,
        EngineConfig(max_slots=8, block_size=16, max_blocks_per_seq=128, num_blocks=1025,
                     prefill_chunk=256),
    )
    eng.warmup()
    V = cfg.vocab_size
    rng = np.random.RandomState(2)

    def toks(n):
        return [int(t) for t in rng.randint(0, V, n)]

    greedy = SamplingParams(max_tokens=32)
    head = toks(256)  # shared head: 16 full blocks
    first = (head + toks(192), greedy)
    rest = [
        (head + toks(64), greedy),
        (head + toks(512), SamplingParams(max_tokens=32, temperature=0.8, top_k=50, top_p=0.95, seed=7)),
        (head[:200] + toks(300), greedy),  # diverges inside block 12: a CoW fork
        (toks(64), greedy),
        (toks(1024), SamplingParams(max_tokens=32, temperature=1.0, seed=11)),
        (toks(100), greedy),
        (head + toks(32), greedy),
        (toks(700), SamplingParams(max_tokens=32, temperature=0.7, top_p=0.9, seed=5)),
    ]
    results: dict[int, tuple] = {}
    errors: list[BaseException] = []

    def client(idx, prompt, sp):
        try:
            req = eng.submit(prompt, sp)
            results[idx] = (prompt, sp, req, list(eng.stream_tokens(req, timeout=600)))
        except BaseException as e:  # surfaced by the main thread below
            errors.append(e)

    # the main path's run starts here: every count from 0
    paged_attention_cuda.launches = 0
    eng.runner.launches = dict.fromkeys(eng.runner.launches, 0)
    base = eng.stats()
    stop = threading.Event()
    loop = threading.Thread(target=eng.run_loop, args=(stop,), daemon=True)
    t_start = time.perf_counter()
    loop.start()
    try:
        # the first request's prompt is fully prefilled (and its blocks in
        # the prefix tree) before the others arrive
        req0 = eng.submit(*first)
        stream0 = eng.stream_tokens(req0, timeout=600)
        tok0 = [next(stream0)]
        threads = [threading.Thread(target=lambda: results.__setitem__(0, (*first, req0, tok0 + list(stream0))))]
        threads += [
            threading.Thread(target=client, args=(idx, *item))
            for idx, item in enumerate(rest, start=1)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if any(t.is_alive() for t in threads):
            raise AssertionError("serve: a client thread did not finish")
        t_end = time.perf_counter()
    finally:
        stop.set()
        loop.join(timeout=60)
    if errors:
        raise errors[0]
    st = eng.stats()
    k1_launches = paged_attention_cuda.launches
    decode_steps = eng.runner.launches["decode"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if len(results) != 1 + len(rest):
        raise AssertionError(f"serve: {len(results)} of {1 + len(rest)} requests returned")
    for idx, (prompt, sp, req, streamed) in sorted(results.items()):
        if req.finish_reason != "length" or len(req.out) != sp.max_tokens or streamed != req.out:
            raise AssertionError(f"serve: request {idx} ended {req.finish_reason} with {len(req.out)} tokens")
        if not all(0 <= t < V for t in req.out) or not np.isfinite(req.out_logprobs).all():
            raise AssertionError(f"serve: request {idx} has out-of-range tokens or non-finite logprobs")
    audit, pc_audit = eng.pool.audit(), eng.prefix_cache.audit()
    if not (audit["ok"] and pc_audit["ok"]):
        raise AssertionError(f"serve: audit failed {audit} {pc_audit}")
    pc = st["prefix_cache"]
    if pc["hit_tokens"] <= 0 or pc["cow_forks"] < 1:
        raise AssertionError(f"serve: expected prefix hits and a CoW fork, got {pc}")
    if decode_steps < 1 or k1_launches != cfg.n_layers * decode_steps:
        raise AssertionError(
            f"serve: K1 launched {k1_launches} times over {decode_steps} decode steps "
            f"(expected {cfg.n_layers} per step)"
        )

    # every greedy token against the dense forward over prompt + output
    checked = excused = 0
    for idx, (prompt, sp, req, _) in sorted(results.items()):
        if sp.temperature > 0:
            continue
        seq = torch.tensor([prompt + req.out[:-1]], device="cuda")
        logits = gptj_forward(cfg, params, seq)[0, len(prompt) - 1 :]  # predicts out[j]
        top2 = logits.topk(2, dim=-1).values
        for j, tok in enumerate(req.out):
            checked += 1
            if tok == int(logits[j].argmax()):
                continue
            gap = float(top2[j, 0] - top2[j, 1])
            behind = float(top2[j, 0] - logits[j, tok])
            if gap >= BF16_TOP2_MARGIN or behind >= BF16_TOP2_MARGIN:
                raise AssertionError(
                    f"serve: request {idx} token {j} = {tok} is {behind:.4f} behind the dense "
                    f"argmax (top-2 gap {gap:.4f}, margin {BF16_TOP2_MARGIN})"
                )
            excused += 1
    print(
        f"greedy check: {checked} tokens against the dense bf16 forward, {excused} differ "
        f"within the top-2 margin {BF16_TOP2_MARGIN}"
    )

    ttft = sorted(r[2].first_token_t - r[2].arrival_t for r in results.values())
    n_tok = st["tokens_generated"] - base["tokens_generated"]
    d_steps = st["decode_steps"] - base["decode_steps"]
    step_ms = (st["decode_s"] - base["decode_s"]) / max(d_steps, 1) * 1e3
    wall = t_end - t_start
    print(
        f"GPT-J-6B serve [{card}]: {len(results)} requests, {n_tok} tokens in {wall:.3f} s "
        f"= {n_tok / wall:.2f} tokens/s; TTFT min/median/max "
        f"{ttft[0] * 1e3:.1f}/{ttft[len(ttft) // 2] * 1e3:.1f}/{ttft[-1] * 1e3:.1f} ms; "
        f"decode step {step_ms:.3f} ms over {d_steps} steps; K1 launches {k1_launches} = "
        f"{cfg.n_layers} x {decode_steps}; prefix hit tokens {pc['hit_tokens']}, cow forks "
        f"{pc['cow_forks']}, preemptions {st['preemptions']}; peak memory {peak_gb:.2f} GB"
    )
    return dict(launches=k1_launches, engine=eng)


def noise_host_ms(eng: LLMEngine, reqs) -> tuple[float, float]:
    """Host time of one decode step's Gumbel noise for ``reqs``' batch, and
    for the same batch made all greedy (mean of 20 calls, device synced)."""
    seeds = [r.params.seed & 0xFFFFFFFF for r in reqs]
    counters = [len(r.out) for r in reqs]
    temp = [r.params.temperature for r in reqs]
    V = eng.model_cfg.vocab_size

    def ms(temps) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            _row_noise(seeds, counters, temps, V, eng.device)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 20

    return ms(temp), ms([0.0] * len(reqs))


def profile_decode(eng: LLMEngine, card: str) -> None:
    """Phase 7: where a steady decode step's time goes — every slot decoding
    after a 512-token prompt (half greedy, half sampled). Ten engine steps
    are timed without the profiler (the wall time the idle share is read
    against), then ten more under torch.profiler for the device time by
    kernel."""
    rng = np.random.RandomState(3)
    V = eng.model_cfg.vocab_size
    params = [
        SamplingParams(max_tokens=64) if i % 2 == 0
        else SamplingParams(max_tokens=64, temperature=0.8, top_k=50, top_p=0.95, seed=i)
        for i in range(eng.cfg.max_slots)
    ]
    reqs = [eng.submit([int(t) for t in rng.randint(0, V, 512)], p) for p in params]
    while not all(r.state == RUNNING for r in reqs):
        eng.step()
    steps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    if not all(r.state == RUNNING for r in reqs):
        raise AssertionError("decode profile: a request finished inside the timed steps")
    noise_ms, noise_greedy_ms = noise_host_ms(eng, reqs)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_ms(events) -> float:
        return sum(e.self_device_time_total for e in events) / 1e3 / steps

    busy = dev_ms(kernels)
    k1 = dev_ms([e for e in kernels if "paged_decode_kernel" in e.key])
    # cuBLAS names its GEMM kernels nvjet_*, *gemm*, *xmma* or cutlass_*
    gemm_words = ("gemm", "nvjet", "xmma", "cutlass")
    gemm = dev_ms([e for e in kernels if any(w in e.key.lower() for w in gemm_words)])
    n_launch = sum(e.count for e in kernels) / steps
    n_sampled = sum(r.params.temperature > 0 for r in reqs)
    print(
        f"decode profile [{card}]: {len(reqs)} slots ({n_sampled} sampled) at context "
        f"~{reqs[0].seq_len}: {wall_ms:.3f} ms/step wall without the profiler, "
        f"{prof_wall_ms:.3f} ms/step with it; host Gumbel noise {noise_ms:.3f} ms/step "
        f"for this batch, {noise_greedy_ms:.3f} ms/step all greedy"
    )
    if busy == 0:
        print("  device time not measured (the profiler saw no device activity)")
    else:
        print(
            f"  device busy {busy:.3f} ms/step (idle share {1 - busy / wall_ms:.3f} of the "
            f"unprofiled step), {n_launch:.0f} device ops/step; GEMM {gemm:.3f} ms, "
            f"K1 {k1:.3f} ms, other {busy - gemm - k1:.3f} ms per step"
        )
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"  {dev_ms([e]):8.3f} ms/step  {e.count // steps:5d}/step  {e.key[:90]}")
    for r in reqs:
        eng.cancel(r.id)
    eng.step()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 device")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, compute capability {torch.cuda.get_device_capability(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {card}")

    phase("2 build")
    t0 = time.perf_counter()
    _kernels.build("paged_attention")
    print(f"built paged_attention in {time.perf_counter() - t0:.1f} s")
    print(_kernels.build_log("paged_attention").strip())

    phase("3 K1 vs plain")
    err = check_k1()

    phase("4 K1 timing")
    timing = time_k1()

    phase("5 fp32 identity")
    fp32_identity()
    torch.cuda.empty_cache()

    phase("6 GPT-J-6B serve")
    served = serve_6b(card)

    phase("7 decode profile")
    profile_decode(served["engine"], card)

    kernels = [dict(
        name="paged_decode_attention",
        route="cuda",
        source="ray_tpu_torch/ops/csrc/paged_attention.cu",
        replaces="ray_tpu/ops/paged_attention.py:203",
        launches=served["launches"],
        max_abs_err=err,
        ms=timing["ms"],
        plain_ms=timing["plain_ms"],
        bound_ms=timing["bound_ms"],
        bound_by="bytes",
        library_ms=timing["library_ms"],
    )]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
