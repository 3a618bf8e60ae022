"""Paged-cache model execution: prefill-chunk and decode-step functions
(port of ``ray_tpu/llm/model_runner.py``) for both of the model zoo's
archs:

* GPT-J (``models.gptj``): rotary positions, parallel residual over one
  layernorm, no q/k/v/out biases, an lm head with bias; its matmul weights
  are stored in the activation dtype.
* GPT (``models.gpt``): learned positions (clamped to ``seq_len - 1`` at
  the embedding: padded prefill-tail positions may run past the table), a
  fused qkv projection with bias split q|k|v, sequential residual through
  ln2, an out-projection bias and no lm-head bias. Its fp32 master weights
  are cast to the activation dtype at each use, as the reference casts
  them: the runner keeps no copies, so a weight swap that writes the
  masters in place (``LLMEngine.update_weights``) reaches every step.
  Mixture-of-experts GPT (``n_experts > 0``) raises, as in the reference.

Both give fp32 logits. Where the dense decoders (``gptj_decode``,
``gpt_decode``) own a per-call cache, these functions write the SHARED
block pool in place — scatter the new positions' k/v into physical
blocks, attend via ``ops.paged_attention`` — where the reference threads
donated pool buffers through its jitted steps. Every step reads the
parameters from ``self.params`` at call time.

* ``decode_step`` — one token per slot, batched across heterogeneous
  sequences (different lengths, block tables, sampling params). Inactive
  slots carry position 0 and an all-trash block table: their writes land
  in reserved block 0 and their sampled tokens are discarded host-side.
  Decode attention is the hand-written CUDA kernel on the card.
* ``prefill_chunk`` — (chunk,) tokens of ONE sequence at positions
  ``start..start+chunk`` (tail-padded; padded positions scatter to the
  trash block). Returns the last valid position's logits. Its attention
  is plain PyTorch, as the reference computes it in XLA.
* ``verify_step`` — (slots, k+1) speculative-decode verification: each
  slot feeds its last emitted token plus ``k`` drafted tokens, their k/v
  scatter PROVISIONALLY into the pool, one multi-query paged attention per
  layer (``ops.paged_verify_attention``, the hand-written verify kernel on
  the card) yields all ``k+1`` positions' logits, and
  ``models.sampling.speculative_verify_logprobs`` accepts a prefix + one
  correction/bonus token per slot. Rejected positions need no device
  rollback — they sit beyond the sequence length, everything masks by
  position, and the next window overwrites them first (the block LEDGER
  rolls back host-side via ``cache.shrink_to``).
* ``fork_blocks`` — copy-on-write block copies for the prefix cache.

Every step reads its inputs as host numpy arrays and copies them to the
device without waiting for the device; the only host sync of a decode
step is the engine's read of the sampled tokens (of a verify step, the
engine's read of the accepted counts and window tokens).

Observability: the first call of each step function at each shape records
one ``llm.compile`` flight-recorder event with its host time
(``first_call_s``). Nothing is traced or compiled here, but that first
call is where the one-time costs land — a kernel's ``nvcc`` build when no
warm-up ran before it, library handle and workspace setup — and a
postmortem wants to see them. Every call of the four step functions is
noted, as in the reference, by the runner's device-step profiler
(``self.prof``, ``util.device_prof.JitProfiler``): its host time goes into
``device_step_seconds{site=decode|prefill|verify|fork}``, and a site that
meets a NEW shape after its first call emits ``llm.retrace`` and bumps
``device_retraces`` (the ``retrace-storm`` SLO rule). Where the reference's
profiler reads a jit cache, each step function here keeps its shape keys
(``_StepKeys``), and their count is its ``_cache_size()``.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.models.gpt import GPTConfig, _linear
from ray_tpu_torch.models.gptj import GPTJConfig, _apply_rotary, _rotary_sincos
from ray_tpu_torch.models.sampling import (
    gumbel_noise,
    row_generator,
    sample_tokens_logprobs,
    speculative_verify_logprobs,
)
from ray_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_prefill_attention_torch,
    paged_verify_attention,
)
from ray_tpu_torch.util.device_prof import JitProfiler


def _rotary_rows(x: torch.Tensor, positions: torch.Tensor, rotary_dim: int) -> torch.Tensor:
    """GPT-J interleaved rotary with PER-ROW positions. x: (n, heads, hd);
    positions: (n,). (models.gptj shares one position vector across the
    batch; decode slots each sit at a different position.)"""
    sin, cos = _rotary_sincos(positions, rotary_dim)  # (n, r/2)
    return _apply_rotary(x, sin[:, None], cos[:, None], rotary_dim)


def _scatter_kv(pool_l: torch.Tensor, vals: torch.Tensor, phys: torch.Tensor, off: torch.Tensor):
    """Write per-row k or v into physical blocks. pool_l: (num_blocks,
    heads, block, d); vals: (n, heads, d); phys/off: (n,). In place, where
    the reference donates the pool to its jitted step so XLA can do the
    same instead of copying the whole pool every call."""
    heads = torch.arange(vals.shape[1], device=vals.device)
    pool_l.index_put_((phys[:, None], heads[None, :], off[:, None]), vals.to(pool_l.dtype))


def _row_noise(seeds, counters, temp, vocab: int, device) -> torch.Tensor:
    """Gumbel noise for a batch: row i keyed by (seeds[i], counters[i]) only,
    so a request draws the same tokens in any slot or step; greedy rows
    (temp <= 0) draw nothing."""
    gens = [
        row_generator(int(s), int(c)) if t > 0 else None
        for s, c, t in zip(seeds, counters, temp)
    ]
    return gumbel_noise(gens, vocab, device)


def _window_noise(seeds, counters, temp, w: int, vocab: int, device) -> torch.Tensor:
    """(slots, w, vocab) Gumbel noise for verify windows: window index i of
    slot s keyed by (seeds[s], counters[s] + i), the key the plain decode
    path uses at that output index. Greedy slots draw nothing; a sampled
    slot draws ``w`` rows on the host."""
    seeds, counters, temp = (np.repeat(np.asarray(a), w) for a in (seeds, counters, temp))
    counters = counters + np.tile(np.arange(w), len(counters) // w)
    return _row_noise(seeds, counters, temp, vocab, device).view(-1, w, vocab)


def _knobs(temp, top_k, top_p, dev):
    """Host per-slot sampling knobs as device tensors, copied without
    waiting for the device."""
    return (
        torch.tensor(np.asarray(temp), dtype=torch.float32).to(dev, non_blocking=True),
        torch.tensor(np.asarray(top_k), dtype=torch.int64).to(dev, non_blocking=True),
        torch.tensor(np.asarray(top_p), dtype=torch.float32).to(dev, non_blocking=True),
    )


def _sample_rows(logits, noise, temp, top_k, top_p):
    """Per-row sampling: (tokens (n,), logprobs (n,)), the chosen-token
    behavior logprob riding along (``models.sampling`` module doc)."""
    return sample_tokens_logprobs(logits, noise, *_knobs(temp, top_k, top_p, logits.device))


def _verify_rows(logits, draft, noise, temp, top_k, top_p):
    """Per-slot speculative verification, batched over slots (same
    per-request determinism as ``_sample_rows``: window token i keys off
    (seed, counter + i) through ``_window_noise``). logits: (S, W, V);
    draft: (S, W-1). Returns (n_accepted (S,), out_tokens (S, W),
    out_logprobs (S, W))."""
    return speculative_verify_logprobs(
        logits, draft, noise, *_knobs(temp, top_k, top_p, logits.device)
    )


def _fork_impl(k_pool, v_pool, src, dst):
    """Copy-on-write block fork: duplicate whole physical blocks across
    every layer, ``pool[:, dst[i]] = pool[:, src[i]]``, in place. A block
    copy is a memmove; recomputing the same positions is L layers of
    matmuls."""
    k_pool[:, dst] = k_pool[:, src]
    v_pool[:, dst] = v_pool[:, src]


class _StepKeys:
    """The shapes one step function has run: eager PyTorch's counterpart of
    a jitted function's executable cache. ``_cache_size()`` is what
    ``JitProfiler`` reads."""

    __slots__ = ("keys",)

    def __init__(self):
        self.keys: set = set()

    def _cache_size(self) -> int:
        return len(self.keys)


class PagedModelRunner:
    """The step functions for one (config, params) pair: a ``GPTJConfig``
    with ``GPTJ`` parameters or a dense ``GPTConfig`` with ``GPT``
    parameters."""

    def __init__(self, cfg, params, block_size: int, device=None):
        if isinstance(cfg, GPTJConfig):
            self.arch = "gptj"
        elif isinstance(cfg, GPTConfig):
            if cfg.n_experts > 0:
                raise NotImplementedError("paged decode supports dense GPT only")
            self.arch = "gpt"
        else:
            raise TypeError(f"unsupported model config {type(cfg).__name__}")
        self.cfg = cfg
        self.params = params
        self.block_size = block_size
        self.device = params.lm_head.weight.device if device is None else torch.device(device)
        #: the heads this runner's q/k/v projections yield: all of them here,
        #: a tp rank's share in ``llm.multichip``
        self.n_heads = cfg.n_heads
        #: step calls per site; a decode step launches the paged decode
        #: kernel once per layer, a verify step the paged verify kernel
        self.launches = {"decode": 0, "prefill": 0, "fork": 0, "verify": 0}
        self._steps = {fn: _StepKeys() for fn in self.launches}  # shape keys already called
        # device-step profiler: per-call host time into device_step_seconds
        # {site=decode|prefill|verify|fork} + retrace detection against each
        # step function's shape keys — a site meeting a new shape after its
        # warmup baseline emits llm.retrace and trips the retrace-storm SLO
        # (per-runner so two engines in one process never compare counts)
        self.prof = JitProfiler(event="llm.retrace")

    def _note_compile(self, fn: str, key: Any, t0: float) -> None:
        """Flight-recorder marker for the first call per (fn, shape): that
        call pays the one-time costs (module doc), and its host time
        dominating an engine's start is what a postmortem needs to see.
        Later calls record nothing."""
        keys = self._steps[fn].keys
        if key in keys:
            return
        keys.add(key)
        _events.record(
            "llm.compile", fn=fn, shape=str(key), arch=self.arch,
            first_call_s=round(time.perf_counter() - t0, 3),
        )

    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype).to(self.device, non_blocking=True)

    # -- shared layer math -------------------------------------------------

    def _embed(self, tokens, positions):
        """(n,) tokens at (n,) positions → (n, d) in the activation dtype."""
        p = self.params
        if self.arch == "gptj":
            return p.embed(tokens)
        # gather fp32 rows, then cast; clamp: padded prefill-tail positions
        # may run past the positional table
        dt = self.cfg.torch_dtype
        pos = positions.clamp_max(self.cfg.seq_len - 1)
        return F.embedding(tokens, p.embed.weight).to(dt) + F.embedding(pos, p.pos_embed.weight).to(dt)

    def _logits(self, x):
        """Final layernorm and the lm head: (n, d) → (n, vocab) fp32."""
        p = self.params
        if self.arch == "gptj":
            return p.logits(x)
        return p.ln_f(x).float() @ p.lm_head.weight.t()

    def _qkv_rows(self, layer, h, positions):
        """h: (n, d) post-ln hidden → q/k/v (n, heads, hd), rotary applied
        for GPT-J."""
        n = h.shape[0]
        nh, hd = self.n_heads, self.cfg.head_dim
        if self.arch == "gptj":
            r = self.cfg.rotary_dim
            q = _rotary_rows(layer.q(h).view(n, nh, hd), positions, r)
            k = _rotary_rows(layer.k(h).view(n, nh, hd), positions, r)
            return q, k, layer.v(h).view(n, nh, hd)
        q, k, v = _linear(h, layer.attn_qkv).split(nh * hd, dim=-1)
        # the split leaves strided views; the attention kernels take q
        # contiguous (k and v are scattered into the pools)
        return q.reshape(n, nh, hd).contiguous(), k.reshape(n, nh, hd), v.reshape(n, nh, hd)

    #: the reduction of the row-parallel partials over ``llm.multichip``'s
    #: ranks (None: one card, nothing to reduce) and this runner's rank
    coll = None
    rank = 0

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.coll is None else self.coll.all_reduce(t)

    def _layer(self, layer, x, positions, attend):
        """One block over rows ``x`` (n, d) at ``positions``; ``attend(q, k,
        v)`` writes the rows' k/v into this layer's pools and returns their
        attention (n, heads, hd). Under tensor parallelism
        (``llm.multichip``) the heads and the MLP's middle are this rank's
        share and ``_reduce`` sums the row-parallel partials; rank 0's
        partial carries ``x`` and the row-parallel biases, added in the
        one-card order, so one card is the same arithmetic."""
        n = x.shape[0]
        first = self.rank == 0
        h = layer.ln1(x)
        att = attend(*self._qkv_rows(layer, h, positions)).to(x.dtype).reshape(n, -1)
        if self.arch == "gptj":
            att = F.linear(att, layer.attn_out.weight)
            mid = F.gelu(layer.mlp_in(h), approximate="tanh")
            mlp = F.linear(mid, layer.mlp_out.weight, layer.mlp_out.bias if first else None)
            # parallel residual: attention and MLP share one reduction
            return self._reduce(x + att + mlp if first else att + mlp)
        dt = x.dtype
        out = layer.attn_out
        att = F.linear(att, out.weight.to(dt), out.bias.to(dt) if first else None)
        h = self._reduce(x + att if first else att)
        mid = F.gelu(_linear(layer.ln2(h), layer.mlp_in), approximate="tanh")
        out = layer.mlp_out
        mlp = F.linear(mid, out.weight.to(dt), out.bias.to(dt) if first else None)
        return self._reduce(h + mlp if first else mlp)  # sequential residual

    # -- decode step -------------------------------------------------------

    @torch.no_grad()
    def decode_step(self, k_pool, v_pool, tokens, positions, tables, temp, top_k, top_p,
                    seeds, counters):
        """One token per slot (all host arrays of length slots; tables
        (slots, tmax)). Writes the slots' k/v into the pools in place and
        returns (next tokens, their logprobs) as device tensors."""
        t0 = time.perf_counter()
        self.launches["decode"] += 1
        noise = _row_noise(seeds, counters, temp, self.cfg.vocab_size, self.device)
        x = self._decode_hidden(k_pool, v_pool, tokens, positions, tables)
        out = _sample_rows(self._logits(x), noise, temp, top_k, top_p)
        self._note_compile("decode", len(tokens), t0)
        self.prof.note("decode", self._steps["decode"], time.perf_counter() - t0)
        return out

    def _decode_hidden(self, k_pool, v_pool, tokens, positions, tables):
        """The decode step's layers: the slots' last hidden rows (S, d)."""
        tok = self._dev(tokens, torch.int64)
        pos = self._dev(positions, torch.int64)
        tbl = self._dev(tables, torch.int32)
        bs = self.block_size
        phys = tbl.long().gather(1, (pos // bs)[:, None])[:, 0]
        off = pos % bs
        lengths = (pos + 1).int()
        x = self._embed(tok, pos)  # (S, d)
        for li, layer in enumerate(self.params.blocks):

            def attend(q, k, v, li=li):
                _scatter_kv(k_pool[li], k, phys, off)
                _scatter_kv(v_pool[li], v, phys, off)
                return paged_attention(q, k_pool[li], v_pool[li], tbl, lengths)

            x = self._layer(layer, x, pos, attend)
        return x

    # -- speculative verification step -------------------------------------

    @torch.no_grad()
    def verify_step(self, k_pool, v_pool, tokens, base_pos, tables, temp, top_k, top_p,
                    seeds, counters):
        """tokens: (slots, w) host array — each slot's last emitted token
        plus its w-1 drafts; base_pos: (slots,) the position of tokens[:,
        0]; the rest as ``decode_step``, per slot. Writes the window's k/v
        into the pools in place and returns (n_accepted (slots,), window
        tokens (slots, w), their logprobs (slots, w)) as device tensors."""
        t0 = time.perf_counter()
        self.launches["verify"] += 1
        S, W = np.shape(tokens)
        # the host noise first, so the layers queue behind it
        noise = _window_noise(seeds, counters, temp, W, self.cfg.vocab_size, self.device)
        x, tok = self._verify_hidden(k_pool, v_pool, tokens, base_pos, tables)
        logits = self._logits(x).view(S, W, -1)
        out = _verify_rows(logits, tok[:, 1:], noise, temp, top_k, top_p)
        self._note_compile("verify", (S, W), t0)
        self.prof.note("verify", self._steps["verify"], time.perf_counter() - t0)
        return out

    def _verify_hidden(self, k_pool, v_pool, tokens, base_pos, tables):
        """The verify step's layers: the windows' hidden rows (S*W, d) and
        the tokens on the device (S, W)."""
        cfg = self.cfg
        S, W = np.shape(tokens)
        tok = self._dev(tokens, torch.int64)
        base = self._dev(base_pos, torch.int64)
        tbl = self._dev(tables, torch.int32)
        bs, tmax = self.block_size, tbl.shape[1]
        positions = base[:, None] + torch.arange(W, device=self.device)[None, :]  # (S, W)
        pos_flat = positions.reshape(-1)
        # window positions can run past the table's reach (a slot one emit
        # away from the length cap still feeds its drafts): the reference
        # clamps the gather, as XLA does, and scatters the overflow rows to
        # the trash block; torch indexing would raise where XLA clamps, so
        # the clamp is explicit. The engine never emits from those rows.
        valid = pos_flat < tmax * bs
        logical = (pos_flat // bs).clamp_max(tmax - 1)
        rows = torch.arange(S, device=self.device).repeat_interleave(W)
        phys = torch.where(valid, tbl.long()[rows, logical], 0)
        off = pos_flat % bs
        # inactive slots carry base 0 and an all-trash table: their queries
        # attend positions 0..i of trash block 0 (finite, discarded)
        pos32 = positions.int()
        # the GEMMs below see S*W rows where a decode step's see S, so
        # cuBLAS may pick other kernels: in bf16 a verify and a plain step
        # can round differently and part at near-ties; fp32 stays identical
        x = self._embed(tok.reshape(-1), pos_flat)  # (S*W, d)
        nh = self.n_heads
        for li, layer in enumerate(self.params.blocks):

            def attend(q, k, v, li=li):
                _scatter_kv(k_pool[li], k, phys, off)
                _scatter_kv(v_pool[li], v, phys, off)
                return paged_verify_attention(
                    q.view(S, W, nh, cfg.head_dim), k_pool[li], v_pool[li], tbl, pos32
                ).reshape(S * W, nh, cfg.head_dim)

            x = self._layer(layer, x, pos_flat, attend)
        return x, tok

    # -- copy-on-write block fork (llm.prefix_cache) -----------------------

    @torch.no_grad()
    def fork_blocks(self, k_pool, v_pool, src, dst):
        """Duplicate physical blocks ``src[i] → dst[i]`` across all layers.
        The engine calls this right after a cache-aware admission whose
        prompt diverges INSIDE a cached block."""
        t0 = time.perf_counter()
        self.launches["fork"] += 1
        _fork_impl(k_pool, v_pool, self._dev(src, torch.int64), self._dev(dst, torch.int64))
        self._note_compile("fork", len(src), t0)
        self.prof.note("fork", self._steps["fork"], time.perf_counter() - t0)

    # -- prefill chunk -----------------------------------------------------

    @torch.no_grad()
    def prefill_chunk(self, k_pool, v_pool, tokens, start: int, n_valid: int, table):
        """tokens: (chunk,) host array, tail-padded; ``start`` the position
        of tokens[0]; ``n_valid`` the valid tokens; table: (tmax,) this
        sequence's block table. Writes k/v in place and returns the last
        valid position's logits (vocab,) fp32 on the device."""
        t0 = time.perf_counter()
        self.launches["prefill"] += 1
        x = self._prefill_hidden(k_pool, v_pool, tokens, start, n_valid, table)
        out = self._logits(x[max(n_valid - 1, 0)][None, :])[0]
        self._note_compile("prefill", len(tokens), t0)
        self.prof.note("prefill", self._steps["prefill"], time.perf_counter() - t0)
        return out

    def _prefill_hidden(self, k_pool, v_pool, tokens, start: int, n_valid: int, table):
        """The prefill chunk's layers: its hidden rows (chunk, d)."""
        chunk = len(tokens)
        bs = self.block_size
        tbl = self._dev(table, torch.int32)
        positions = torch.arange(start, start + chunk, device=self.device)
        valid = torch.arange(chunk, device=self.device) < n_valid
        # padded tail positions can run past the table; the reference's
        # XLA gather clamps such indices, torch indexing would raise
        logical = (positions // bs).clamp_max(tbl.shape[0] - 1)
        phys = torch.where(valid, tbl.long()[logical], 0)  # padded → trash
        off = positions % bs
        x = self._embed(self._dev(tokens, torch.int64), positions)  # (chunk, d)
        for li, layer in enumerate(self.params.blocks):

            def attend(q, k, v, li=li):
                _scatter_kv(k_pool[li], k, phys, off)
                _scatter_kv(v_pool[li], v, phys, off)
                return paged_prefill_attention_torch(q, k_pool[li], v_pool[li], tbl, positions)

            x = self._layer(layer, x, positions, attend)
        return x

    # -- weights -----------------------------------------------------------

    def weight_specs(self) -> dict:
        """``{name: (shape, dtype)}`` of the model's parameters, in
        ``state_dict`` order: what ``LLMEngine.update_weights`` holds a new
        set against."""
        return {n: (tuple(t.shape), t.dtype) for n, t in self.params.state_dict(keep_vars=True).items()}

    @torch.no_grad()
    def load_weights(self, new) -> None:
        """Write a validated ``{name: tensor}`` set INTO the parameter
        storage (``copy_`` on the current stream, the steps' stream), so
        the next step reads it and nothing that captured a storage keeps
        stale weights."""
        for name, dst in self.params.state_dict(keep_vars=True).items():
            dst.copy_(new[name])

    def close(self) -> None:
        """Release what the runner holds beyond its tensors: nothing here,
        the follower processes of ``llm.multichip``'s runner."""
