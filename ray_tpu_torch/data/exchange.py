"""All-to-all exchanges: repartition, random_shuffle, sort, groupby/aggregate
(port of ``ray_tpu/data/exchange.py`` on numpy-dict blocks).

Reference: ``python/ray/data/_internal/planner/exchange/`` (push-based
shuffle: partition map tasks + reduce tasks). Map tasks here use
``num_returns=P`` so each reducer fetches exactly its partition's objects —
no broadcast of the whole shuffle through one process.

The seeding is the reference's (``default_rng(seed + salt)`` per map task,
``default_rng(seed * 7919 + salt)`` per reducer), so a seeded shuffle of the
same blocks gives the reference's row order. Sorting is numpy's stable
argsort key by key, which orders rows as the reference's Arrow ``sort_by``
does (NaN last in both directions).
"""

from __future__ import annotations

from typing import Any

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.context import DataContext


def launch(kind: str, bundles: list, options: dict, ctx: DataContext):
    """Returns a list of (blocks_ref, meta_ref) for the reduce tasks."""
    if not bundles:
        return []
    if kind == "repartition":
        return _repartition(bundles, options["num_blocks"], ctx)
    if kind == "random_shuffle":
        return _shuffle(bundles, options.get("seed"), ctx)
    if kind == "sort":
        return _sort(bundles, options["key"], options.get("descending", False), ctx)
    if kind == "aggregate":
        return _aggregate(bundles, options.get("key"), options["aggs"], ctx)
    if kind == "map_groups":
        return _map_groups(bundles, options["key"], options["fn"], options.get("batch_format", "numpy"), ctx)
    raise ValueError(f"Unknown all-to-all kind {kind!r}")


def _num_partitions(bundles, ctx) -> int:
    return max(1, min(len(bundles), ctx.max_shuffle_partitions))


def _stable_hash(v) -> int:
    """Deterministic across processes (Python's hash() is salted per process;
    worker processes would route the same string key to different partitions)."""
    import zlib

    if isinstance(v, bytes):
        data = v
    elif isinstance(v, str):
        data = v.encode()
    else:
        data = repr(v).encode()
    return zlib.crc32(data)


# -- repartition -------------------------------------------------------------


def _repartition(bundles, num_blocks: int, ctx):
    total = sum(b.num_rows for b in bundles)
    per = -(-total // num_blocks) if total else 0
    # Only ship the bundles overlapping each output row range.
    offsets = np.cumsum([0] + [b.num_rows for b in bundles])
    remote = ray_tpu_torch.remote(_repartition_reduce).options(num_returns=2)
    out = []
    for i in range(num_blocks):
        start, end = i * per, min((i + 1) * per, total)
        if start >= end and total:
            # Emit an empty block to honor the requested count.
            start = end = total
        sel = [
            (b.blocks_ref, int(offsets[j]))
            for j, b in enumerate(bundles)
            if offsets[j + 1] > start and offsets[j] < end
        ] or [(bundles[0].blocks_ref, 0)]
        refs = [r for r, _ in sel]
        base = sel[0][1]
        out.append(remote.remote(start - base, end - base, *refs))
    return out


def _repartition_reduce(start: int, end: int, *all_blocks):
    from ray_tpu_torch.data.execution import _slice_rows

    block = _slice_rows(list(all_blocks), start, end)
    return [block], [BlockAccessor.for_block(block).get_metadata()]


# -- random shuffle ----------------------------------------------------------


def _shuffle(bundles, seed, ctx):
    P = _num_partitions(bundles, ctx)
    part = ray_tpu_torch.remote(_shuffle_map).options(num_returns=P)
    cols = [part.remote(b.blocks_ref, P, seed, i) for i, b in enumerate(bundles)]
    reduce = ray_tpu_torch.remote(_shuffle_reduce).options(num_returns=2)
    out = []
    for p in range(P):
        out.append(reduce.remote(seed, p, *[c[p] if P > 1 else c for c in cols]))
    return out


def _shuffle_map(blocks: list[Block], P: int, seed, salt: int):
    t = BlockAccessor.concat(blocks)
    acc = BlockAccessor.for_block(t)
    n = acc.num_rows()
    rng = np.random.default_rng(None if seed is None else seed + salt)
    assign = rng.integers(0, P, size=n)
    parts = []
    for p in range(P):
        idx = np.nonzero(assign == p)[0]
        parts.append(acc.take_indices(idx))
    return tuple(parts) if P > 1 else parts[0]


def _shuffle_reduce(seed, salt: int, *parts):
    t = BlockAccessor.concat(list(parts))
    acc = BlockAccessor.for_block(t)
    rng = np.random.default_rng(None if seed is None else seed * 7919 + salt)
    perm = rng.permutation(acc.num_rows())
    block = acc.take_indices(perm)
    return [block], [BlockAccessor.for_block(block).get_metadata()]


# -- sort --------------------------------------------------------------------


def _sort(bundles, key, descending: bool, ctx):
    P = _num_partitions(bundles, ctx)
    keys = [key] if isinstance(key, str) else list(key)
    primary = keys[0]
    # Stage 0: sample to pick range boundaries (reference: SortTaskSpec
    # sample_boundaries).
    sampler = ray_tpu_torch.remote(_sort_sample)
    samples = ray_tpu_torch.get([sampler.remote(b.blocks_ref, primary) for b in bundles])
    nonempty = [s for s in samples if len(s)]
    allv = np.concatenate(nonempty) if nonempty else np.array([])
    if len(allv) == 0:
        P = 1
        boundaries = np.array([])
    else:
        allv = np.sort(allv)
        qs = np.linspace(0, 1, P + 1)[1:-1]
        boundaries = np.quantile(allv, qs) if np.issubdtype(allv.dtype, np.number) else np.array(
            [allv[int(q * (len(allv) - 1))] for q in qs]
        )
    part = ray_tpu_torch.remote(_sort_map).options(num_returns=max(P, 1))
    cols = [part.remote(b.blocks_ref, primary, boundaries, descending) for b in bundles]
    reduce = ray_tpu_torch.remote(_sort_reduce).options(num_returns=2)
    out = []
    order = range(P - 1, -1, -1) if descending else range(P)
    for p in order:
        out.append(reduce.remote(keys, descending, *[c[p] if P > 1 else c for c in cols]))
    return out


def _sort_sample(blocks: list[Block], key: str):
    t = BlockAccessor.concat(blocks)
    if BlockAccessor.for_block(t).num_rows() == 0 or key not in t:
        return np.array([])
    col = t[key]
    if len(col) > 200:
        col = np.random.default_rng(0).choice(col, 200, replace=False)
    return col


def _sort_map(blocks: list[Block], key: str, boundaries: np.ndarray, descending: bool):
    t = BlockAccessor.concat(blocks)
    acc = BlockAccessor.for_block(t)
    P = len(boundaries) + 1
    if P == 1:
        return t
    if acc.num_rows() == 0:
        return tuple(t for _ in range(P))
    col = t[key]
    assign = np.searchsorted(boundaries, col, side="right")
    parts = [acc.take_indices(np.nonzero(assign == p)[0]) for p in range(P)]
    return tuple(parts)


def _sort_reduce(keys: list[str], descending: bool, *parts):
    t = BlockAccessor.concat(list(parts))
    acc = BlockAccessor.for_block(t)
    if acc.num_rows():
        t = acc.take_indices(sort_indices(t, keys, descending))
    return [t], [BlockAccessor.for_block(t).get_metadata()]


def sort_indices(block: Block, keys: list[str], descending: bool) -> np.ndarray:
    """Row order of a stable multi-key sort, every key in one direction, NaN
    last — the order of Arrow's ``sort_by`` (least significant key first,
    each pass a stable argsort of the rows' ranks)."""
    n = BlockAccessor.for_block(block).num_rows()
    order = np.arange(n)
    for k in reversed(keys):
        col = block[k][order]
        nan = _is_nan(col)
        _, rank = np.unique(col[~nan], return_inverse=True)
        ranks = np.empty(n, dtype=np.int64)
        ranks[~nan] = -rank if descending else rank
        ranks[nan] = np.iinfo(np.int64).max
        order = order[np.argsort(ranks, kind="stable")]
    return order


def _is_nan(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind in "fc":
        return np.isnan(col)
    if col.dtype == object:
        return np.array([isinstance(x, float) and x != x for x in col], dtype=bool)
    return np.zeros(len(col), dtype=bool)


# -- groupby / aggregate -----------------------------------------------------


def _aggregate(bundles, key, aggs, ctx):
    from ray_tpu_torch.data.aggregate import AggregateFn

    aggs = list(aggs)
    if key is None:
        # Global aggregation: per-bundle partial states + one combine task.
        part = ray_tpu_torch.remote(_agg_partial)
        partials = [part.remote(b.blocks_ref, None, aggs) for b in bundles]
        final = ray_tpu_torch.remote(_agg_finalize).options(num_returns=2)
        return [final.remote(None, aggs, *partials)]
    P = _num_partitions(bundles, ctx)
    part = ray_tpu_torch.remote(_agg_hash_partial).options(num_returns=P)
    cols = [part.remote(b.blocks_ref, key, aggs, P) for b in bundles]
    final = ray_tpu_torch.remote(_agg_finalize).options(num_returns=2)
    return [final.remote(key, aggs, *[c[p] if P > 1 else c for c in cols]) for p in range(P)]


def _group_partials(t, key, aggs):
    """block → {group_key_tuple: [state, ...]} partial aggregation."""
    acc = BlockAccessor.for_block(t)
    batch = acc.to_numpy_batch()
    states: dict[Any, list] = {}
    if acc.num_rows() == 0:
        return states
    if key is None:
        groups = {None: np.arange(acc.num_rows())}
    else:
        col = batch[key]
        uniq, inv = np.unique(col, return_inverse=True)
        groups = {uniq[i].item() if hasattr(uniq[i], "item") else uniq[i]: np.nonzero(inv == i)[0] for i in range(len(uniq))}
    for gk, idx in groups.items():
        sub = {k: v[idx] for k, v in batch.items()}
        states[gk] = [a.partial(sub) for a in aggs]
    return states


def _merge_states(all_states: list[dict], aggs):
    merged: dict[Any, list] = {}
    for states in all_states:
        for gk, st in states.items():
            if gk not in merged:
                merged[gk] = st
            else:
                merged[gk] = [a.merge(x, y) for a, x, y in zip(aggs, merged[gk], st)]
    return merged


def _agg_partial(blocks: list[Block], key, aggs):
    return _group_partials(BlockAccessor.concat(blocks), key, aggs)


def _agg_hash_partial(blocks: list[Block], key, aggs, P: int):
    t = BlockAccessor.concat(blocks)
    states = _group_partials(t, key, aggs)
    parts: list[dict] = [{} for _ in range(P)]
    for gk, st in states.items():
        parts[_stable_hash(gk) % P][gk] = st
    return tuple(parts) if P > 1 else parts[0]


def _agg_finalize(key, aggs, *all_states):
    merged = _merge_states(list(all_states), aggs)
    rows = []
    for gk in sorted(merged, key=lambda x: (x is None, x)):
        row = {} if key is None else {key: gk}
        for a, st in zip(aggs, merged[gk]):
            row[a.name] = a.finalize(st)
        rows.append(row)
    block = BlockAccessor.rows_to_block(rows)
    return [block], [BlockAccessor.for_block(block).get_metadata()]


# -- map_groups --------------------------------------------------------------


def _map_groups(bundles, key, fn, batch_format, ctx):
    """GroupedData.map_groups: hash-partition rows by key, then apply ``fn``
    to each whole group (reference: ``grouped_data.py`` map_groups)."""
    P = _num_partitions(bundles, ctx)
    part = ray_tpu_torch.remote(_hash_partition_rows).options(num_returns=P)
    cols = [part.remote(b.blocks_ref, key, P) for b in bundles]
    reduce = ray_tpu_torch.remote(_map_groups_reduce).options(num_returns=2)
    return [reduce.remote(key, fn, batch_format, *[c[p] if P > 1 else c for c in cols]) for p in range(P)]


def _hash_partition_rows(blocks: list[Block], key: str, P: int):
    t = BlockAccessor.concat(blocks)
    acc = BlockAccessor.for_block(t)
    if acc.num_rows() == 0:
        return tuple(t for _ in range(P)) if P > 1 else t
    col = acc.to_numpy_batch()[key]
    assign = np.asarray([_stable_hash(v.item() if hasattr(v, "item") else v) % P for v in col])
    parts = [acc.take_indices(np.nonzero(assign == p)[0]) for p in range(P)]
    return tuple(parts) if P > 1 else parts[0]


def _map_groups_reduce(key, fn, batch_format, *parts):
    t = BlockAccessor.concat(list(parts))
    acc = BlockAccessor.for_block(t)
    out_blocks: list = []
    if acc.num_rows():
        batch = acc.to_numpy_batch()
        col = batch[key]
        uniq = sorted({v.item() if hasattr(v, "item") else v for v in col})
        for gk in uniq:
            idx = np.nonzero(col == gk)[0]
            sub_block = acc.take_indices(idx)
            sub_acc = BlockAccessor.for_block(sub_block)
            group = sub_acc.to_pandas() if batch_format == "pandas" else sub_acc.to_numpy_batch()
            out = fn(group)
            out_blocks.append(BlockAccessor.batch_to_block(out))
    block = BlockAccessor.concat(out_blocks)
    return [block], [BlockAccessor.for_block(block).get_metadata()]
