"""Paged KV-cache block pool: two device tensors plus a host-side ledger
(port of ``ray_tpu/llm/cache.py``).

The device side is two fixed tensors per model

    k, v : (layers, num_blocks, heads, block_size, head_dim)

allocated ONCE at engine start on the engine's device. The model runner
writes them in place (the reference donates the buffers to its jitted
steps; in PyTorch the in-place write is the same saving without the
ceremony). The host side is a free-list ledger mapping sequence ids to the
physical blocks they own; block tables (logical→physical per sequence,
padded with the reserved trash block) are plain int32 numpy rows the
engine stacks into the decode step's ``(slots, tmax)`` operand.

Block 0 is RESERVED as the trash block: inactive decode slots and padded
prefill positions scatter their k/v there, so masked lanes never corrupt
live cache. Eviction under pressure is mechanism here (``free`` returns a
sequence's blocks), policy in ``llm.scheduler``.

Sharing (``llm.prefix_cache``): every allocated block carries a REFERENCE
COUNT — one per owning sequence plus one while the prefix tree retains it
(``cache_retain``/``cache_release``). ``allocate`` can seed a sequence's
table with already-resident ``shared`` blocks (the matched prefix), and a
block returns to the free list only when its count reaches zero. A block
whose only reference is the cache's is *evictable*. Copy-on-write is
split: the LEDGER fork (a fresh exclusive block for the divergent tail)
happens here, the device copy in ``model_runner.fork_blocks``. Shared
blocks are read-only by construction — prefill starts past the matched
prefix and decode writes only at the sequence tail.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Pool geometry. ``num_blocks`` INCLUDES the reserved trash block, so
    usable capacity is ``num_blocks - 1`` blocks of ``block_size`` tokens.
    ``max_blocks_per_seq`` fixes the block-table width (tmax) — it caps a
    single sequence's length at ``max_blocks_per_seq * block_size``."""

    num_blocks: int = 128
    block_size: int = 16
    max_blocks_per_seq: int = 32

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is reserved)")
        if self.block_size < 1 or self.max_blocks_per_seq < 1:
            raise ValueError("block_size and max_blocks_per_seq must be >= 1")

    @property
    def max_seq_len(self) -> int:
        return self.max_blocks_per_seq * self.block_size


class KVBlockPool:
    """The pool: device tensors + thread-safe host ledger. ``device=None``
    means the CUDA device (``device.resolve_device``)."""

    def __init__(
        self,
        cfg: CacheConfig,
        n_layers: int,
        n_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        self.cfg = cfg
        device = resolve_device(device)
        shape = (n_layers, cfg.num_blocks, n_heads, cfg.block_size, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self._lock = threading.Lock()
        # LIFO free list of physical block ids; 0 reserved (trash)
        self._free = list(range(cfg.num_blocks - 1, 0, -1))
        self._owned: dict[str, list[int]] = {}
        # reference counts for every non-free block: one per owning
        # sequence + one while the prefix tree retains it; a block is
        # freed only at zero
        self._ref: dict[int, int] = {}
        self._cache_held: set[int] = set()

    # -- capacity ----------------------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.cfg.block_size)

    @property
    def block_bytes(self) -> int:
        """Device bytes ONE physical block occupies across both pool tensors
        and every layer (k + v) — the unit the HBM ledger multiplies block
        counts by."""
        return (self.k.nbytes + self.v.nbytes) // self.cfg.num_blocks

    @property
    def device_bytes(self) -> int:
        """Total device footprint of the pool tensors (k + v), trash block
        included — allocated once at engine start, never resized."""
        return self.k.nbytes + self.v.nbytes

    @property
    def num_free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def num_used_blocks(self) -> int:
        """DISTINCT blocks referenced by at least one sequence (a shared
        block counts once; cache-only residents count zero)."""
        with self._lock:
            return len({b for bs in self._owned.values() for b in bs})

    @property
    def num_cached_blocks(self) -> int:
        with self._lock:
            return len(self._cache_held)

    @property
    def num_evictable_blocks(self) -> int:
        """Blocks whose ONLY reference is the prefix cache's — capacity the
        scheduler can reclaim without preempting anyone."""
        with self._lock:
            return sum(1 for b in self._cache_held if self._ref.get(b) == 1)

    def ledger_counts(self) -> dict:
        """One consistent snapshot of the block partition for the HBM ledger
        (a single lock acquisition — separate property reads could
        interleave with an allocation): ``free`` + ``seq_owned`` (distinct
        blocks owned by >= 1 sequence, shared or not) + ``cache_only``
        (resident purely for the prefix tree) partition the usable blocks,
        the invariant ``audit()`` checks."""
        with self._lock:
            owned = {b for bs in self._owned.values() for b in bs}
            return {
                "free": len(self._free),
                "seq_owned": len(owned),
                "cache_only": len(self._cache_held - owned),
            }

    def utilization(self) -> float:
        """Fraction of usable (non-reserved) blocks owned by live
        sequences; cache-only blocks are evictable and excluded."""
        usable = self.cfg.num_blocks - 1
        return self.num_used_blocks / max(usable, 1)

    def can_allocate(self, n_tokens: int, shared: int = 0) -> bool:
        """True when a fresh allocation for ``n_tokens`` fits, with the
        first ``shared`` blocks coming from the prefix cache."""
        need = self.blocks_for(n_tokens)
        if need > self.cfg.max_blocks_per_seq:
            return False
        with self._lock:
            return need - shared <= len(self._free)

    # -- ledger ------------------------------------------------------------

    def allocate(self, seq_id: str, n_tokens: int, shared: Sequence[int] = ()) -> list[int]:
        """Claim enough blocks for ``n_tokens``; raises if the sequence
        already owns blocks, exceeds the table width, or the pool is dry.
        ``shared`` — already-resident cache blocks forming the head of the
        table — each gain a reference instead of leaving the free list.
        All-or-nothing: validation precedes any mutation."""
        need = self.blocks_for(n_tokens)
        shared = list(shared)
        with self._lock:
            if seq_id in self._owned:
                raise ValueError(f"sequence {seq_id!r} already owns blocks")
            if need > self.cfg.max_blocks_per_seq:
                raise ValueError(
                    f"{n_tokens} tokens need {need} blocks > "
                    f"max_blocks_per_seq={self.cfg.max_blocks_per_seq}"
                )
            if len(shared) >= need and shared:
                raise ValueError(
                    f"{len(shared)} shared blocks >= {need} needed: the "
                    "tail block must be exclusive (prefill writes there)"
                )
            for b in shared:
                if b not in self._cache_held or self._ref.get(b, 0) < 1:
                    raise ValueError(f"shared block {b} is not cache-resident")
            fresh = need - len(shared)
            if fresh > len(self._free):
                raise MemoryError(
                    f"paged KV pool exhausted: need {fresh} blocks, {len(self._free)} free"
                )
            for b in shared:
                self._ref[b] += 1
            new = [self._free.pop() for _ in range(fresh)]
            for b in new:
                self._ref[b] = 1
            blocks = shared + new
            self._owned[seq_id] = blocks
            return list(blocks)

    def grow_to(self, seq_id: str, n_tokens: int) -> bool:
        """Ensure ``seq_id`` owns enough blocks for ``n_tokens``. Returns
        False (allocation unchanged) when the pool can't cover the growth."""
        with self._lock:
            blocks = self._owned.get(seq_id)
            if blocks is None:
                raise KeyError(f"unknown sequence {seq_id!r}")
            need = self.blocks_for(n_tokens)
            if need > self.cfg.max_blocks_per_seq:
                return False
            extra = need - len(blocks)
            if extra <= 0:
                return True
            if extra > len(self._free):
                return False
            for _ in range(extra):
                b = self._free.pop()
                self._ref[b] = 1
                blocks.append(b)
            return True

    def _deref_locked(self, block: int) -> bool:
        """Drop one reference (lock held); True when the block hit zero and
        went back to the free list."""
        n = self._ref.get(block, 0) - 1
        if n > 0:
            self._ref[block] = n
            return False
        self._ref.pop(block, None)
        self._cache_held.discard(block)
        self._free.append(block)
        return True

    def shrink_to(self, seq_id: str, n_tokens: int) -> int:
        """Return the sequence's TAIL blocks beyond what ``n_tokens`` needs
        to the free list; returns the number released (the speculative-
        decode rollback)."""
        with self._lock:
            blocks = self._owned.get(seq_id)
            if blocks is None:
                raise KeyError(f"unknown sequence {seq_id!r}")
            keep = self.blocks_for(n_tokens)
            excess = len(blocks) - keep
            if excess <= 0:
                return 0
            tail = blocks[keep:]
            del blocks[keep:]
            for b in reversed(tail):
                self._deref_locked(b)
            return excess

    def free(self, seq_id: str) -> int:
        """Drop the sequence's references (idempotent); returns how many
        blocks reached zero and returned to the free list."""
        with self._lock:
            blocks = self._owned.pop(seq_id, None)
            if not blocks:
                return 0
            return sum(1 for b in reversed(blocks) if self._deref_locked(b))

    def owner_count(self) -> int:
        with self._lock:
            return len(self._owned)

    def blocks_of(self, seq_id: str) -> list[int]:
        """Copy of the sequence's block list (table order)."""
        with self._lock:
            blocks = self._owned.get(seq_id)
            if blocks is None:
                raise KeyError(f"unknown sequence {seq_id!r}")
            return list(blocks)

    # -- prefix-cache residency (llm.prefix_cache) -------------------------

    def cache_retain(self, block: int) -> bool:
        """Take the prefix tree's reference on an allocated block (False if
        the block is free/unknown, or already retained)."""
        with self._lock:
            if block not in self._ref or block in self._cache_held:
                return False
            self._cache_held.add(block)
            self._ref[block] += 1
            return True

    def cache_release(self, block: int) -> bool:
        """Drop the prefix tree's reference; frees the block when no
        sequence still holds it."""
        with self._lock:
            if block not in self._cache_held:
                return False
            self._cache_held.discard(block)
            return self._deref_locked(block)

    def ref(self, block: int) -> int:
        with self._lock:
            return self._ref.get(block, 0)

    def is_cache_held(self, block: int) -> bool:
        with self._lock:
            return block in self._cache_held

    def is_evictable(self, block: int) -> bool:
        """Only the cache references it: reclaimable without preemption."""
        with self._lock:
            return block in self._cache_held and self._ref.get(block) == 1

    def cache_held_blocks(self) -> set:
        with self._lock:
            return set(self._cache_held)

    def audit(self) -> dict:
        """Free-list ledger invariant check: free + owned + cache-only must
        PARTITION the usable blocks, every id must be in range, and every
        refcount must equal its observable references (#owning sequences
        + 1 if cache-held)."""
        with self._lock:
            free = list(self._free)
            owned = {k: list(v) for k, v in self._owned.items()}
            cache_held = set(self._cache_held)
            ref = dict(self._ref)
        usable = self.cfg.num_blocks - 1
        owner_count: dict[int, int] = {}
        for bs in owned.values():
            for b in bs:
                owner_count[b] = owner_count.get(b, 0) + 1
        live = set(owner_count) | cache_held
        all_blocks = free + sorted(live)
        duplicates = len(all_blocks) != len(set(all_blocks))
        out_of_range = sum(1 for b in all_blocks if not (1 <= b < self.cfg.num_blocks))
        missing = usable - len(all_blocks)
        ref_errors = sum(
            1
            for b in live
            if ref.get(b, 0) != owner_count.get(b, 0) + (1 if b in cache_held else 0)
        ) + sum(1 for b in ref if b not in live)
        return {
            "ok": not duplicates and not out_of_range and missing == 0 and ref_errors == 0,
            "free": len(free),
            "owned": len(owner_count),
            "owners": list(owned),
            "shared": sum(1 for n in owner_count.values() if n > 1),
            "cached": len(cache_held),
            "cached_only": sum(1 for b in cache_held if b not in owner_count),
            "ref_errors": ref_errors,
            "missing": missing,  # >0 leaked, <0 double-counted
            "duplicates": duplicates,
            "out_of_range": out_of_range,
        }

    def table_row(self, seq_id: Optional[str]) -> np.ndarray:
        """(max_blocks_per_seq,) int32 block table, padded with the trash
        block. ``None`` (an inactive slot) is all-trash."""
        row = np.zeros(self.cfg.max_blocks_per_seq, np.int32)
        if seq_id is not None:
            with self._lock:
                blocks = self._owned.get(seq_id)
                if blocks is None:
                    raise KeyError(f"unknown sequence {seq_id!r}")
                row[: len(blocks)] = blocks
        return row
