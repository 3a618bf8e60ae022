"""Paged-cache model execution: prefill-chunk and decode-step functions
(port of ``ray_tpu/llm/model_runner.py``, GPT-J only).

Where ``gptj_decode`` owns a dense per-call cache, these functions write
the SHARED block pool in place — scatter the new positions' k/v into
physical blocks, attend via ``ops.paged_attention`` — where the reference
threads donated pool buffers through its jitted steps.

* ``decode_step`` — one token per slot, batched across heterogeneous
  sequences (different lengths, block tables, sampling params). Inactive
  slots carry position 0 and an all-trash block table: their writes land
  in reserved block 0 and their sampled tokens are discarded host-side.
  Decode attention is the hand-written CUDA kernel on the card.
* ``prefill_chunk`` — (chunk,) tokens of ONE sequence at positions
  ``start..start+chunk`` (tail-padded; padded positions scatter to the
  trash block). Returns the last valid position's logits. Its attention
  is plain PyTorch, as the reference computes it in XLA.
* ``fork_blocks`` — copy-on-write block copies for the prefix cache.

Every step reads its inputs as host numpy arrays and copies them to the
device without waiting for the device; the only host sync of a decode
step is the engine's read of the sampled tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.models.gptj import GPTJ, GPTJConfig, _apply_rotary, _rotary_sincos
from ray_tpu_torch.models.sampling import gumbel_noise, row_generator, sample_tokens_logprobs
from ray_tpu_torch.ops.paged_attention import paged_attention, paged_prefill_attention_torch


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


def _sample_rows(logits, noise, temp, top_k, top_p):
    """Per-row sampling: (tokens (n,), logprobs (n,)), the chosen-token
    behavior logprob riding along (``models.sampling`` module doc)."""
    dev = logits.device
    return sample_tokens_logprobs(
        logits,
        noise,
        torch.tensor(np.asarray(temp), dtype=torch.float32).to(dev, non_blocking=True),
        torch.tensor(np.asarray(top_k), dtype=torch.int64).to(dev, non_blocking=True),
        torch.tensor(np.asarray(top_p), dtype=torch.float32).to(dev, non_blocking=True),
    )


def _fork_impl(k_pool, v_pool, src, dst):
    """Copy-on-write block fork: duplicate whole physical blocks across
    every layer, ``pool[:, dst[i]] = pool[:, src[i]]``, in place. A block
    copy is a memmove; recomputing the same positions is L layers of
    matmuls."""
    k_pool[:, dst] = k_pool[:, src]
    v_pool[:, dst] = v_pool[:, src]


class PagedModelRunner:
    """The step functions for one (config, params) pair."""

    def __init__(self, cfg: GPTJConfig, params: GPTJ, block_size: int):
        if not isinstance(cfg, GPTJConfig):
            raise NotImplementedError(
                f"the port's paged engine runs GPT-J only, got {type(cfg).__name__} "
                "(the GPT arch is queued in ROADMAP.md)"
            )
        self.cfg = cfg
        self.params = params
        self.block_size = block_size
        self.device = params.lm_head.weight.device
        #: step calls per site; a decode step launches the paged decode
        #: kernel once per layer
        self.launches = {"decode": 0, "prefill": 0, "fork": 0}

    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype).to(self.device, non_blocking=True)

    def _qkv_rows(self, layer, h, positions):
        """h: (n, d) post-ln hidden → q/k/v (n, heads, hd), rotary applied."""
        n = h.shape[0]
        nh, hd, r = self.cfg.n_heads, self.cfg.head_dim, self.cfg.rotary_dim
        q = _rotary_rows(layer.q(h).view(n, nh, hd), positions, r)
        k = _rotary_rows(layer.k(h).view(n, nh, hd), positions, r)
        return q, k, layer.v(h).view(n, nh, hd)

    # -- decode step -------------------------------------------------------

    @torch.no_grad()
    def decode_step(self, k_pool, v_pool, tokens, positions, tables, temp, top_k, top_p,
                    seeds, counters):
        """One token per slot (all host arrays of length slots; tables
        (slots, tmax)). Writes the slots' k/v into the pools in place and
        returns (next tokens, their logprobs) as device tensors."""
        self.launches["decode"] += 1
        cfg, p = self.cfg, self.params
        noise = _row_noise(seeds, counters, temp, cfg.vocab_size, self.device)
        tok = self._dev(tokens, torch.int64)
        pos = self._dev(positions, torch.int64)
        tbl = self._dev(tables, torch.int32)
        bs = self.block_size
        phys = tbl.long().gather(1, (pos // bs)[:, None])[:, 0]
        off = pos % bs
        lengths = (pos + 1).int()
        x = p.embed(tok)  # (S, d)
        for li, layer in enumerate(p.blocks):
            h = layer.ln1(x)
            q, k, v = self._qkv_rows(layer, h, pos)
            _scatter_kv(k_pool[li], k, phys, off)
            _scatter_kv(v_pool[li], v, phys, off)
            att = paged_attention(q, k_pool[li], v_pool[li], tbl, lengths)
            att = layer.attn_out(att.to(x.dtype).reshape(x.shape[0], cfg.d_model))
            x = x + att + layer.mlp(h)  # parallel residual
        return _sample_rows(p.logits(x), noise, temp, top_k, top_p)

    # -- copy-on-write block fork (llm.prefix_cache) -----------------------

    @torch.no_grad()
    def fork_blocks(self, k_pool, v_pool, src, dst):
        """Duplicate physical blocks ``src[i] → dst[i]`` across all layers.
        The engine calls this right after a cache-aware admission whose
        prompt diverges INSIDE a cached block."""
        self.launches["fork"] += 1
        _fork_impl(k_pool, v_pool, self._dev(src, torch.int64), self._dev(dst, torch.int64))

    # -- prefill chunk -----------------------------------------------------

    @torch.no_grad()
    def prefill_chunk(self, k_pool, v_pool, tokens, start: int, n_valid: int, table):
        """tokens: (chunk,) host array, tail-padded; ``start`` the position
        of tokens[0]; ``n_valid`` the valid tokens; table: (tmax,) this
        sequence's block table. Writes k/v in place and returns the last
        valid position's logits (vocab,) fp32 on the device."""
        self.launches["prefill"] += 1
        cfg, p = self.cfg, self.params
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
        x = p.embed(self._dev(tokens, torch.int64))  # (chunk, d)
        for li, layer in enumerate(p.blocks):
            h = layer.ln1(x)
            q, k, v = self._qkv_rows(layer, h, positions)
            _scatter_kv(k_pool[li], k, phys, off)
            _scatter_kv(v_pool[li], v, phys, off)
            att = paged_prefill_attention_torch(q, k_pool[li], v_pool[li], tbl, positions)
            att = layer.attn_out(att.to(x.dtype).reshape(chunk, cfg.d_model))
            x = x + att + layer.mlp(h)
        return p.logits(x[max(n_valid - 1, 0)][None, :])[0]
