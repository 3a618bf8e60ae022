"""Tensor-parallel paged inference: the multi-card LLM engine substrate
(port of ``ray_tpu/llm/multichip.py``).

The single-card serving stack (``llm.cache`` pool, ``llm.model_runner``
steps, ``ops.paged_attention``) caps the servable model at one card's
memory. This module lifts exactly that stack onto ``tp`` cards with the
classic Megatron column/row split, chosen so the PAGED layout shards for
free:

* **KV block pool** — the head axis is split: every rank holds
  ``(layers, num_blocks, heads / tp, block_size, head_dim)`` of its own
  heads. Block ids are GLOBAL (every rank holds the same blocks' local
  heads), so the host-side ledger, block tables, prefix-cache radix tree,
  watchdog ``audit()`` and CoW fork bookkeeping are untouched and live on
  the leader alone; the only sharded thing is the payload.
* **Attention** — per-head math never crosses heads: q/k/v projections are
  column-parallel (each rank computes its own heads; GPT's fused qkv rows
  in the mesh's tp-major order, ``parallel.sharding.qkv_order``), the paged
  scatter and the kernels K1/K2 run on the local heads, and only the output
  projection is row-parallel.
* **MLP** — ``mlp_in`` column-parallel, ``mlp_out`` row-parallel. GPT-J's
  parallel residual lets attention and MLP share ONE ``all_reduce`` a
  layer; GPT has two.
* **Everything else** — the embedding (and GPT's positions) and the
  layernorms are replicated. The final layernorm, the lm head and the
  sampling run on the leader alone: its activations after the last
  reduction are the replicated ones, and the Gumbel noise is drawn on its
  host, so followers need neither the head nor seeds.

One process per card, where the reference drives every device from one
controller: the engine's process is rank 0, the leader, and ``tp - 1``
follower processes run the same layers on their shards
(``llm._tp_worker``: the step protocol and the follower loop, over
``_private.local_group``'s private process group). Each step the leader sends the followers the step's host
arrays, then every rank runs the step; the reductions are ``all_reduce``
over the private group, where the reference ``psum``s over its mesh.

The three steps (decode, prefill, verify) and the CoW ``fork_blocks`` keep
the single-card signatures of ``PagedModelRunner`` — ``LLMEngine``,
speculative decoding, preemption-recompute, failover ``resume_tokens``,
the prefix cache, the watchdog and hot swap run UNCHANGED on top;
``EngineConfig(tp=N)`` is the only switch.

Numerics: every rank runs the single-card runner's own layer
(``PagedModelRunner._layer``) with its ``coll`` set: rank 0 adds the
replicated residual and the row-parallel biases to its partial before the
reduction, in the one-card order, so at tp 1 (no reduction) the
arithmetic is the single card's, bit for bit. At tp > 1
the two row-parallel contractions are summed across ranks in another
order, so activations drift by ~1 ulp a layer; greedy argmax and seeded
sampling absorb that (``tests/test_torch_llm_multichip.py``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ray_tpu_torch._private import local_group as lg
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.llm import _tp_worker as tpw
from ray_tpu_torch.llm.cache import CacheConfig, KVBlockPool
from ray_tpu_torch.llm.model_runner import PagedModelRunner, _fork_impl
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.models.gptj import GPTJConfig


def _per_device_bytes(labels, own: int, reports, key: str) -> dict:
    """device label -> bytes resident there: the leader's ``own`` count
    under ``labels[0]``, each follower's last report's ``key`` under its
    label (a replicated tensor counts once PER rank: that copy is real
    memory). The HBM ledger's per-device section reads this."""
    out = {labels[0]: own}
    for label, rep in zip(labels[1:], reports):
        out[label] = int(rep[key])
    return out


def _check_tp(cfg, tp: int) -> None:
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if cfg.n_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads} not divisible by tp={tp}")
    if cfg.d_ff % tp:
        raise ValueError(f"d_ff={cfg.d_ff} not divisible by tp={tp}")


class ShardedKVBlockPool(KVBlockPool):
    """KV block pool whose tensors hold this rank's heads; the followers of
    ``group`` (``TensorParallelPagedModelRunner.group``) hold the other
    heads' in their processes. The host ledger (free list, refcounts,
    audit) is inherited verbatim — block ids are global, so every ledger
    invariant and the watchdog's leak audit hold for any tp.
    ``block_bytes`` and ``device_bytes`` are pool-wide (every rank's);
    ``per_device_bytes`` splits them."""

    def __init__(
        self,
        cfg: CacheConfig,
        n_layers: int,
        n_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.float32,
        device=None,
        *,
        tp: int = 1,
        group=None,
    ):
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if n_heads % tp:
            raise ValueError(
                f"n_heads={n_heads} not divisible by tp={tp} — the pool shards the head axis"
            )
        if tp > 1 and (group is None or group.tp != tp):
            raise ValueError(
                f"a pool over tp={tp} needs the runner's group of {tp} ranks "
                "(TensorParallelPagedModelRunner.group): its followers hold the other heads"
            )
        self.tp = tp
        super().__init__(cfg, n_layers, n_heads // tp, head_dim, dtype, device)
        self._reports: list = []
        if group is not None and group.procs:
            group.command(
                tpw.OP_POOL,
                (cfg.num_blocks, cfg.block_size, n_layers, n_heads // tp, head_dim,
                 tpw.DTYPES.index(str(dtype).removeprefix("torch."))),
            )
            self._reports = group.replies("pool")
        self._labels = group.label if group is not None else [lg._label(str(self.k.device), 0)]

    @property
    def block_bytes(self) -> int:
        return super().block_bytes * self.tp

    @property
    def device_bytes(self) -> int:
        return super().device_bytes * self.tp

    def per_device_bytes(self) -> dict:
        """Local pool bytes per device — ``device_bytes / tp`` each, the
        whole point of sharding the pool."""
        return _per_device_bytes(self._labels, self.k.nbytes + self.v.nbytes, self._reports, "pool_bytes")


class TensorParallelPagedModelRunner(PagedModelRunner):
    """``PagedModelRunner`` over ``tp`` ranks: this process (rank 0, on
    ``device``) and ``tp - 1`` follower processes it starts
    (``llm._tp_worker``). The step methods keep the single-card
    signatures; each first sends the followers its host arrays, then runs
    the base step, whose layers reduce over ``self.coll``
    (``PagedModelRunner._layer``).

    ``params`` is the whole model (a ``GPT``/``GPTJ`` module or its
    ``state_dict``) on ``device`` or on the CPU; each rank receives its
    slice one parameter at a time. At tp 1 a parameter already on
    ``device`` in its dtype is adopted, not copied: the runner holds no
    second copy of the model, and ``update_weights`` writes into those
    tensors as the single-card engine does. Over more ranks every rank
    holds copies, and the caller's module is never written."""

    def __init__(self, cfg, params, block_size: int, *, tp: int, device=None):
        if not isinstance(cfg, (GPTJConfig, GPTConfig)):
            raise TypeError(f"unsupported model config {type(cfg).__name__}")
        _check_tp(cfg, tp)
        dev = resolve_device(device)
        full = params if isinstance(params, Mapping) else params.state_dict()
        local = self._adopt(cfg, full, tp, dev)
        super().__init__(cfg, local, block_size, device=dev)
        self.tp = tp
        self.n_heads = cfg.n_heads // tp
        self._specs = {n: (tuple(t.shape), t.dtype) for n, t in full.items()}
        self.group = tpw.TPGroup(cfg, tp, dev, block_size)
        # a reduction over one rank is the identity: at tp 1 none is issued
        # (XLA drops a psum over a one-device mesh the same way); one NCCL
        # call a layer made GPT-J-6B's tp-1 decode step 1.45-1.75x the
        # single-card engine's on an H100 (PERF.md §6)
        self.coll = self.group.coll if tp > 1 else None
        self._reports: list = []
        try:
            self.load_weights(full)
        except BaseException:
            self.group.close()
            raise

    @staticmethod
    def _adopt(cfg, full, tp: int, dev) -> nn.Module:
        """The leader's module: at tp 1 the parameters already on ``dev`` in
        their dtype are taken as they are; the rest get fresh storage."""
        local = tpw.local_module(cfg, tp, "meta", leader=True)
        for path, p in list(local.named_parameters()):
            src = full[path]
            mod_path, _, leaf = path.rpartition(".")
            mod = local.get_submodule(mod_path)
            if tp == 1 and src.device == dev and src.dtype == p.dtype:
                t = src.detach()
            else:
                t = torch.empty(p.shape, dtype=p.dtype, device=dev)
            mod._parameters[leaf] = nn.Parameter(t, requires_grad=False)
        return local

    # -- weights -----------------------------------------------------------

    def weight_specs(self) -> dict:
        return dict(self._specs)

    @torch.no_grad()
    def load_weights(self, new) -> None:
        """Send every rank its slice of the validated ``{name: tensor}`` set
        (``_tp_worker.place``), each written INTO the existing local
        storage; the followers then report their bytes."""
        self.group.command(tpw.OP_SWAP)
        tpw.place(self.coll, self.params, new, self.tp, self.device)
        self._reports = self.group.replies("placed")

    def per_device_param_bytes(self) -> dict:
        """device label -> parameter bytes resident there (this rank's
        column/row slices and its copy of every replicated parameter; the
        leader's also the head)."""
        return _per_device_bytes(
            self.group.label, tpw.storage_bytes(self.params.parameters()), self._reports, "params_bytes"
        )

    def follower_reports(self) -> list[dict]:
        """Each follower's kernel launches and step calls so far, and its
        resident bytes (chip runs read the launches: a follower counts its
        own)."""
        self.group.command(tpw.OP_REPORT)
        return self.group.replies("report")

    def trace_next_step(self) -> None:
        """Have each follower run its next step under the profiler; after
        the step, ``group.replies("trace")`` gives each one's host time,
        device busy time and NCCL time (``local_group.traced``)."""
        self.group.command(tpw.OP_TRACE)

    def close(self) -> None:
        self.group.close()

    # -- steps: tell the followers, then run the base step -------------------

    def decode_step(self, k_pool, v_pool, tokens, positions, tables, *sampling):
        tables = np.asarray(tables)
        self.group.command(tpw.OP_DECODE, (len(tokens), tables.shape[1]), (tokens, positions, tables))
        return self.group.guarded(super().decode_step, k_pool, v_pool, tokens, positions, tables, *sampling)

    def verify_step(self, k_pool, v_pool, tokens, base_pos, tables, *sampling):
        tables = np.asarray(tables)
        S, W = np.shape(tokens)
        self.group.command(tpw.OP_VERIFY, (S, W, tables.shape[1]), (tokens, base_pos, tables))
        return self.group.guarded(super().verify_step, k_pool, v_pool, tokens, base_pos, tables, *sampling)

    def prefill_chunk(self, k_pool, v_pool, tokens, start: int, n_valid: int, table):
        table = np.asarray(table)
        self.group.command(tpw.OP_PREFILL, (len(tokens), len(table), start, n_valid), (tokens, table))
        return self.group.guarded(super().prefill_chunk, k_pool, v_pool, tokens, start, n_valid, table)

    def fork_blocks(self, k_pool, v_pool, src, dst):
        self.group.command(tpw.OP_FORK, (len(src),), (src, dst))
        return self.group.guarded(super().fork_blocks, k_pool, v_pool, src, dst)


class _Follower(PagedModelRunner):
    """A follower's runner (``llm._tp_worker.main``): its shard of the
    model, its pool of the local heads, and the step bodies without the
    head."""

    def __init__(self, spec: dict):
        cfg = (GPTJConfig if spec["arch"] == "gptj" else GPTConfig)(**spec["cfg"])
        dev = torch.device(spec["device"])
        tp, rank = spec["tp"], spec["rank"]
        _, pg = lg.make_group(spec["backend"], spec["port"], rank, tp)
        local = tpw.local_module(cfg, tp, dev, leader=False)
        super().__init__(cfg, local, spec["block_size"], device=dev)
        self.tp, self.rank, self.coll = tp, rank, lg.Collectives(pg)
        self.n_heads = cfg.n_heads // tp
        self.k = self.v = None

    def _bytes(self) -> dict:
        pool = 0 if self.k is None else self.k.nbytes + self.v.nbytes
        return dict(params_bytes=tpw.storage_bytes(self.params.parameters()), pool_bytes=pool)

    @torch.no_grad()
    def run(self, op: int, f: list, a: np.ndarray):
        """One command; returns (reply kind, fields) or None."""
        if op == tpw.OP_DECODE:
            S, tmax = f[:2]
            self.launches["decode"] += 1
            self._decode_hidden(self.k, self.v, a[:S], a[S : 2 * S], a[2 * S :].reshape(S, tmax))
        elif op == tpw.OP_VERIFY:
            S, W, tmax = f[:3]
            self.launches["verify"] += 1
            n = S * W
            self._verify_hidden(self.k, self.v, a[:n].reshape(S, W), a[n : n + S],
                                a[n + S :].reshape(S, tmax))
        elif op == tpw.OP_PREFILL:
            chunk, tmax, start, n_valid = f[:4]
            self.launches["prefill"] += 1
            self._prefill_hidden(self.k, self.v, a[:chunk], start, n_valid, a[chunk : chunk + tmax])
        elif op == tpw.OP_FORK:
            n = f[0]
            self.launches["fork"] += 1
            _fork_impl(self.k, self.v, self._dev(a[:n], torch.int64), self._dev(a[n : 2 * n], torch.int64))
        elif op == tpw.OP_POOL:
            nb, bs, layers, heads, hd, code = f
            shape = (layers, nb, heads, bs, hd)
            dt = getattr(torch, tpw.DTYPES[code])
            self.k = torch.zeros(shape, dtype=dt, device=self.device)
            self.v = torch.zeros(shape, dtype=dt, device=self.device)
            return "pool", self._bytes()
        elif op == tpw.OP_SWAP:
            tpw.place(self.coll, self.params, None, self.tp, self.device)
            return "placed", self._bytes()
        elif op == tpw.OP_REPORT:
            from ray_tpu_torch.ops.paged_attention import paged_attention_cuda, paged_verify_attention_cuda

            return "report", dict(self._bytes(), steps=dict(self.launches),
                                  k1=paged_attention_cuda.launches, k2=paged_verify_attention_cuda.launches)
        else:
            raise ValueError(f"unknown tp command {op}")
        return None
