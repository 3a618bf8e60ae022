"""Cross-request prefix cache: a radix tree of shared KV blocks (copy of
``ray_tpu/llm/prefix_cache.py``).

Prefill work becomes proportional to the *uncached suffix*: a tree keyed
by block contents maps token blocks to resident physical KV blocks, and
requests whose prompt walks an existing path borrow those blocks instead
of recomputing them. For two sequences whose first ``P`` tokens are
identical, the KV entries at positions ``0..P-1`` are identical too, so
prefix reuse is exact — outputs are token-identical with the cache on or
off.

* **one node per full block** — a child edge is keyed by the EXACT
  ``block_size``-token tuple it covers and carries the physical block id
  holding those positions' k/v. A root-to-node path spells a prompt
  prefix; its block ids are a ready-made block-table prefix.
* **copy-on-write fork on divergence inside a block** — the partially
  matching child's block is forked (the engine device-copies it into a
  fresh block, ``model_runner.fork_blocks``) and prefill resumes at the
  divergence point, not the block boundary.
* **refcounts in the pool** — a block drops to the free list only at zero;
  a cached block whose sequences all finished (ref == 1) is *evictable*.
* **LRU eviction under pressure** — evictable leaf blocks go first, before
  any live request is preempted; node removal and the pool release happen
  together, so the tree never holds a dangling block id.
* **drafting corpus** — ``paths`` lists the most recently used root-to-leaf
  token sequences for the n-gram drafter (``llm.drafter``).
* **flush on a weight swap** — ``flush`` drops the whole tree (its k/v was
  computed under the old parameters) and bumps ``epoch``; ``insert``
  refuses blocks of a request admitted under an older epoch, whose
  prefill straddled the swap.

All tree mutations happen under the engine lock; the internal lock makes
reads (stats, audit) safe from other threads, the watchdog's included.
Lock order is always engine → cache → pool; the pool never calls back up.

Observability: ``llm.prefix.*`` flight-recorder events (``hit`` /
``insert`` / ``evict`` / ``flush``) and the ``llm_prefix_cache_*`` metric
family; ``audit()`` is part of the watchdog's leak audit.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Optional, Sequence

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.llm.cache import KVBlockPool

#: the metric family this module exports (the reference's names)
METRIC_NAMES = (
    "llm_prefix_cache_hit_tokens",
    "llm_prefix_cache_miss_tokens",
    "llm_prefix_cache_evicted_blocks",
    "llm_prefix_cache_hit_rate",
    "llm_prefix_cache_blocks",
)

_METRICS = None
_METRICS_LOCK = threading.Lock()


def _metrics() -> dict:
    global _METRICS
    if _METRICS is not None:
        return _METRICS
    with _METRICS_LOCK:
        if _METRICS is not None:
            return _METRICS
        from ray_tpu_torch.util.metrics import Counter, Gauge

        _METRICS = {
            "hit_tokens": Counter(
                "llm_prefix_cache_hit_tokens",
                "prompt tokens served from cached KV blocks (prefill skipped)",
            ),
            "miss_tokens": Counter(
                "llm_prefix_cache_miss_tokens",
                "prompt tokens that had to be prefilled (cache miss)",
            ),
            "evicted": Counter(
                "llm_prefix_cache_evicted_blocks",
                "cached KV blocks evicted under pool pressure",
            ),
            "hit_rate": Gauge(
                "llm_prefix_cache_hit_rate",
                "lifetime hit_tokens / (hit_tokens + miss_tokens)",
            ),
            "blocks": Gauge(
                "llm_prefix_cache_blocks", "KV blocks resident in the prefix tree"
            ),
        }
    return _METRICS


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of matching a prompt against the tree.

    ``blocks`` are the physical ids of fully-matched cached blocks, in
    prompt order. ``cow_src``/``cow_tokens`` describe a partial match
    inside the NEXT block: fork ``cow_src`` and its first ``cow_tokens``
    positions are already valid. ``matched`` is the total token count,
    always capped at ``len(prompt) - 1`` so at least one token remains to
    prefill (the final prefill position's logits seed generation)."""

    blocks: tuple = ()
    matched: int = 0
    cow_src: Optional[int] = None
    cow_tokens: int = 0


class _Node:
    """One cached block: the exact tokens it covers and where they live."""

    __slots__ = ("tokens", "block", "children", "parent", "last_used")

    def __init__(self, tokens: tuple, block: int, parent: "_Node"):
        self.tokens = tokens
        self.block = block
        self.children: dict = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    """Radix tree over the pool's blocks (module doc). One per engine."""

    def __init__(self, pool: KVBlockPool):
        self.pool = pool
        self._root = _Node((), -1, None)  # sentinel: no block, no tokens
        self._by_block: dict[int, _Node] = {}
        self._clock = itertools.count(1)
        self._lock = threading.Lock()
        #: bumped by every flush(). Admission stamps the current epoch onto
        #: the request; ``insert`` refuses blocks from an older epoch — a
        #: request mid-prefill across a weight swap computed (some of) its
        #: KV under the OLD parameters, and re-registering it would hand
        #: stale KV to the very requests the flush protects.
        self.epoch = 0
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.evicted_blocks = 0
        self.cow_forks = 0

    # -- matching ----------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> PrefixMatch:
        """Longest cached prefix of ``tokens`` (full blocks + an optional
        intra-block CoW tail), capped at ``len(tokens) - 1``. Touches the
        matched path's LRU clock; counts nothing — ``record`` does, once
        the match is actually used."""
        bs = self.pool.cfg.block_size
        limit = len(tokens) - 1  # >= 1 token must remain to prefill
        with self._lock:
            node = self._root
            blocks: list[int] = []
            i = 0
            while i + bs <= limit:
                child = node.children.get(tuple(tokens[i : i + bs]))
                if child is None:
                    break
                blocks.append(child.block)
                child.last_used = next(self._clock)
                node = child
                i += bs
            cow_src: Optional[int] = None
            cow_tokens = 0
            rem = limit - i
            if rem >= 1 and node.children:
                tail = tuple(tokens[i : i + min(rem, bs)])
                best_len = 0
                best: Optional[_Node] = None
                for key, child in node.children.items():
                    n = 0
                    for a, b in zip(key, tail):
                        if a != b:
                            break
                        n += 1
                    if n > best_len:
                        best_len, best = n, child
                if best is not None:
                    cow_src, cow_tokens = best.block, best_len
                    best.last_used = next(self._clock)
            return PrefixMatch(
                blocks=tuple(blocks), matched=i + cow_tokens, cow_src=cow_src, cow_tokens=cow_tokens
            )

    def record(self, req, match: PrefixMatch, total_tokens: int) -> None:
        """Account a COMMITTED match (the request was admitted with it):
        hit/miss counters, hit-rate gauge, and the ``llm.prefix.hit`` event
        when anything was actually reused."""
        m = _metrics()
        matched = match.matched
        missed = max(total_tokens - matched, 0)
        with self._lock:
            self.hit_tokens += matched
            self.miss_tokens += missed
            if match.cow_src is not None:
                self.cow_forks += 1
            hits, misses = self.hit_tokens, self.miss_tokens
        if matched:
            m["hit_tokens"].inc(matched)
        if missed:
            m["miss_tokens"].inc(missed)
        m["hit_rate"].set(hits / max(hits + misses, 1))
        if matched:
            _events.record(
                "llm.prefix.hit", request_id=req.trace_id, engine_req=req.id,
                matched_tokens=matched, blocks=len(match.blocks),
                cow_tokens=match.cow_tokens, miss_tokens=missed,
            )

    # -- insertion ---------------------------------------------------------

    def insert(self, tokens: Sequence[int], blocks: Sequence[int], limit: int,
               epoch: Optional[int] = None) -> int:
        """Register the sequence's fully-prefilled prompt blocks: block
        ``b`` is inserted once positions ``[b*bs, (b+1)*bs)`` all sit below
        ``limit`` (callers pass ``min(prefill_pos, len(prompt))`` — only
        PROMPT blocks are cacheable). Existing nodes are touched, not
        duplicated; a new node takes a cache reference on the block.
        Returns the number of nodes created.

        ``epoch`` — the flush epoch the sequence was ADMITTED under
        (``self.epoch`` at admission). A stale epoch means a weight swap
        flushed the tree mid-prefill: this sequence's KV is (partly)
        old-parameter output and must not re-enter the tree."""
        if epoch is not None and epoch != self.epoch:
            return 0
        bs = self.pool.cfg.block_size
        n_full = min(limit // bs, len(blocks))
        created = 0
        with self._lock:
            node = self._root
            for b in range(n_full):
                key = tuple(tokens[b * bs : (b + 1) * bs])
                child = node.children.get(key)
                if child is None:
                    blk = blocks[b]
                    if blk in self._by_block:
                        break  # one node per physical block
                    # the node is built BEFORE the pool reference is taken,
                    # so nothing that can raise sits between the retain and
                    # the tree registration (a stranded reference would leak)
                    fresh = _Node(key, blk, node)
                    # only blocks the pool can take a reference on (a block
                    # freed between prefill and insert must not resurrect)
                    if not self.pool.cache_retain(blk):
                        break
                    child = fresh
                    node.children[key] = child
                    self._by_block[blk] = child
                    created += 1
                child.last_used = next(self._clock)
                node = child
            n_nodes = len(self._by_block)
        if created:
            _metrics()["blocks"].set(n_nodes)
            _events.record("llm.prefix.insert", blocks=created, total=n_nodes)
        return created

    # -- eviction ----------------------------------------------------------

    def evict(self, n_blocks: int, protect: frozenset = frozenset()) -> int:
        """Free up to ``n_blocks`` evictable blocks (cache-only refcount,
        leaf nodes, least-recently-used first), skipping ``protect`` (the
        blocks an in-flight admission is about to share). Returns the
        number freed."""
        freed = 0
        with self._lock:
            while freed < n_blocks:
                best: Optional[_Node] = None
                for blk, node in self._by_block.items():
                    if node.children or blk in protect:
                        continue
                    if not self.pool.is_evictable(blk):
                        continue
                    if best is None or node.last_used < best.last_used:
                        best = node
                if best is None:
                    break
                del best.parent.children[best.tokens]
                del self._by_block[best.block]
                self.pool.cache_release(best.block)
                freed += 1
            self.evicted_blocks += freed
            n_nodes = len(self._by_block)
        if freed:
            m = _metrics()
            m["evicted"].inc(freed)
            m["blocks"].set(n_nodes)
            _events.record(
                "llm.prefix.evict", blocks=freed, remaining=n_nodes,
                reason="pressure",
            )
        return freed

    def flush(self, reason: str = "flush") -> int:
        """Drop the whole tree (weight hot-swap: cached k/v was computed
        under the old parameters) and bump ``epoch``. Blocks still
        referenced by in-flight sequences keep THEIR references — only the
        cache's are released; such blocks return to the free list when
        their sequences finish. Returns the number of blocks dropped;
        ``reason`` rides the ``llm.prefix.flush`` event."""
        with self._lock:
            n = len(self._by_block)
            for blk in list(self._by_block):
                self.pool.cache_release(blk)
            self._by_block.clear()
            self._root = _Node((), -1, None)
            self.epoch += 1  # in-flight prefills may no longer insert
        if n:
            _metrics()["blocks"].set(0)
            _events.record("llm.prefix.flush", blocks=n, reason=reason)
        return n

    # -- drafting corpus ---------------------------------------------------

    def paths(self, max_paths: int = 8) -> list:
        """Root-to-leaf token sequences, most recently used first — the
        cross-request drafting corpus (``NGramDrafter.corpus``): a warm
        request's continuation often literally already sits on a cached
        path another request prefilled. Bounded by ``max_paths`` so the
        per-step drafting cost stays constant."""
        with self._lock:
            leaves = [n for n in self._by_block.values() if not n.children]
            leaves.sort(key=lambda n: n.last_used, reverse=True)
            out = []
            for leaf in leaves[:max_paths]:
                rev = []
                node = leaf
                while node is not None and node.block != -1:
                    rev.append(node.tokens)
                    node = node.parent
                seq: list[int] = []
                for toks in reversed(rev):
                    seq.extend(toks)
                out.append(seq)
            return out

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            hits, misses = self.hit_tokens, self.miss_tokens
            return {
                "cached_blocks": len(self._by_block),
                "nodes": len(self._by_block),
                "hit_tokens": hits,
                "miss_tokens": misses,
                "hit_rate": hits / max(hits + misses, 1),
                "evicted_blocks": self.evicted_blocks,
                "cow_forks": self.cow_forks,
            }

    def audit(self) -> dict:
        """Tree↔pool cross-check: every tree node's block must be
        cache-held in the pool, every cache-held pool block must have a
        tree node, and parent links must be intact."""
        with self._lock:
            nodes = dict(self._by_block)
            held = self.pool.cache_held_blocks()
            dangling = [
                b
                for b, n in nodes.items()
                if b not in held or n.parent is None or n.parent.children.get(n.tokens) is not n
            ]
            unindexed = [b for b in held if b not in nodes]
        return {
            "ok": not dangling and not unindexed,
            "nodes": len(nodes),
            "dangling": dangling,
            "unindexed": unindexed,
        }
