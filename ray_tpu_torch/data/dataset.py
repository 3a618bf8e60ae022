"""Dataset: the lazy, distributed data-frame of ray_tpu_torch.data (port of
``ray_tpu/data/dataset.py`` on numpy-dict blocks).

Reference: ``python/ray/data/dataset.py`` (transformations build a logical
plan; consumption triggers the streaming executor), ``grouped_data.py``
(GroupedData), ``dataset.py:1161`` (streaming_split). All transformations
are lazy and fused where legal; consumption streams bundles out of the
executor without materializing the whole dataset in the driver.

``iter_torch_batches`` feeds torch (the card by default), or a device
mesh with ``sharding=NamedSharding(mesh, spec)`` (the reference's
``iter_jax_batches(sharding=...)``); there is no ``iter_jax_batches``. ``to_pandas`` and ``to_arrow_refs`` import their
package when called. ``split`` and ``train_test_split`` execute the plan in
the driver and hand out materialized shares, where upstream streams.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import plan as L
from ray_tpu_torch.data.aggregate import AggregateFn, Count, Max, Mean, Min, Std, Sum
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.datasource import write_block
from ray_tpu_torch.data.execution import RefBundle, StreamingExecutor
from ray_tpu_torch.data.iterator import DataIterator, SplitCoordinator, SplitIterator


class Dataset:
    def __init__(self, plan: L.LogicalPlan):
        self._plan = plan

    # -- transformations (lazy) ---------------------------------------------

    def _with(self, op: L.LogicalOp) -> "Dataset":
        return Dataset(self._plan.with_op(op))

    def map(self, fn, *, fn_args=(), fn_kwargs=None, num_cpus=None, concurrency=None, compute=None, fn_constructor_args=()) -> "Dataset":
        return self._with(L.MapRows(fn=fn, fn_args=tuple(fn_args), fn_kwargs=fn_kwargs or {}, num_cpus=num_cpus, concurrency=concurrency, compute=compute, fn_constructor_args=tuple(fn_constructor_args)))

    def map_batches(
        self,
        fn,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        fn_args=(),
        fn_kwargs=None,
        fn_constructor_args=(),
        fn_constructor_kwargs=None,
        num_cpus=None,
        num_gpus=None,
        compute=None,
        concurrency=None,
        zero_copy_batch: bool = False,
    ) -> "Dataset":
        return self._with(
            L.MapBatches(
                fn=fn,
                fn_args=tuple(fn_args),
                fn_kwargs=fn_kwargs or {},
                fn_constructor_args=tuple(fn_constructor_args),
                fn_constructor_kwargs=fn_constructor_kwargs or {},
                num_cpus=num_cpus,
                num_gpus=num_gpus,
                compute=compute,
                concurrency=concurrency,
                batch_size=batch_size,
                batch_format=batch_format,
                zero_copy_batch=zero_copy_batch,
            )
        )

    def flat_map(self, fn, **kwargs) -> "Dataset":
        return self._with(L.FlatMap(fn=fn, **_map_opts(kwargs)))

    def filter(self, fn, **kwargs) -> "Dataset":
        return self._with(L.Filter(fn=fn, **_map_opts(kwargs)))

    def add_column(self, name: str, fn: Callable[[dict], Any]) -> "Dataset":
        def add(batch, _name=name, _fn=fn):
            batch[_name] = np.asarray(_fn(batch))
            return batch

        return self._with(L.MapBatches(fn=add, batch_format="numpy"))

    def drop_columns(self, cols: list[str]) -> "Dataset":
        def drop(batch, _cols=tuple(cols)):
            return {k: v for k, v in batch.items() if k not in _cols}

        return self._with(L.MapBatches(fn=drop, batch_format="numpy"))

    def select_columns(self, cols: list[str]) -> "Dataset":
        def select(batch, _cols=tuple(cols)):
            missing = [c for c in _cols if c not in batch]
            if missing:
                raise KeyError(f"Columns not found: {missing}")
            return {k: batch[k] for k in _cols}

        return self._with(L.MapBatches(fn=select, batch_format="numpy"))

    def rename_columns(self, mapping: dict[str, str]) -> "Dataset":
        def rename(batch, _m=tuple(mapping.items())):
            m = dict(_m)
            return {m.get(k, k): v for k, v in batch.items()}

        return self._with(L.MapBatches(fn=rename, batch_format="numpy"))

    def random_sample(self, fraction: float, *, seed: Optional[int] = None) -> "Dataset":
        def sample(batch, _f=fraction, _seed=seed):
            n = len(next(iter(batch.values()))) if batch else 0
            if _seed is None:
                rng = np.random.default_rng()
            else:
                # Decorrelate blocks: an identically-seeded rng per block
                # would pick the SAME row positions in every block. Mix the
                # seed with a content fingerprint (deterministic across runs
                # and across worker processes).
                import zlib

                first = next(iter(batch.values()))
                try:
                    fp = zlib.crc32(np.ascontiguousarray(first).tobytes())
                except (TypeError, ValueError):
                    fp = zlib.crc32(repr(first[:8].tolist()).encode())
                rng = np.random.default_rng([_seed, fp, n])
            mask = rng.random(n) < _f
            return {k: v[mask] for k, v in batch.items()}

        return self._with(L.MapBatches(fn=sample, batch_format="numpy"))

    def limit(self, n: int) -> "Dataset":
        return self._with(L.Limit(limit=n))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with(L.AllToAll(kind="repartition", options={"num_blocks": num_blocks}))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._with(L.AllToAll(kind="random_shuffle", options={"seed": seed}))

    def sort(self, key: Union[str, list[str]], descending: bool = False) -> "Dataset":
        return self._with(L.AllToAll(kind="sort", options={"key": key, "descending": descending}))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._with(L.Union(others=[o._plan for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._with(L.Zip(other=other._plan))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    # -- global aggregations -------------------------------------------------

    def aggregate(self, *aggs: AggregateFn) -> dict:
        ds = self._with(L.AllToAll(kind="aggregate", options={"key": None, "aggs": list(aggs)}))
        rows = ds.take_all()
        return rows[0] if rows else {}

    def sum(self, on: str):
        return self.aggregate(Sum(on)).get(f"sum({on})")

    def min(self, on: str):
        return self.aggregate(Min(on)).get(f"min({on})")

    def max(self, on: str):
        return self.aggregate(Max(on)).get(f"max({on})")

    def mean(self, on: str):
        return self.aggregate(Mean(on)).get(f"mean({on})")

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(Std(on, ddof)).get(f"std({on})")

    def unique(self, column: str) -> list:
        rows = self.groupby(column).count().take_all()
        return sorted(r[column] for r in rows)

    # -- consumption ---------------------------------------------------------

    def iter_bundles(self) -> Iterator[RefBundle]:
        yield from StreamingExecutor(self._plan.copy())

    def _iterator_source(self):
        for bundle in self.iter_bundles():
            yield bundle.blocks_ref

    def iterator(self) -> DataIterator:
        return DataIterator(self._iterator_source)

    def iter_rows(self) -> Iterator[dict]:
        return self.iterator().iter_rows()

    def iter_batches(self, **kwargs) -> Iterator[Any]:
        return self.iterator().iter_batches(**kwargs)

    def iter_torch_batches(self, **kwargs) -> Iterator[dict]:
        return self.iterator().iter_torch_batches(**kwargs)

    def take(self, limit: int = 20) -> list[dict]:
        out = []
        for row in self.limit(limit).iter_rows():
            out.append(row)
            if len(out) >= limit:
                break
        return out

    def take_all(self) -> list[dict]:
        return list(self.iter_rows())

    def take_batch(self, batch_size: int = 20, *, batch_format: str = "numpy"):
        for batch in self.limit(batch_size).iter_batches(
            batch_size=batch_size, batch_format=batch_format, prefetch_batches=0
        ):
            return batch
        return {}

    def count(self) -> int:
        # Metadata-only when possible: sum bundle row counts, no block fetch.
        return sum(b.num_rows for b in self.iter_bundles())

    def schema(self):
        for bundle in self.iter_bundles():
            for m in bundle.metas:
                if m.schema is not None:
                    return m.schema
        return None

    def columns(self) -> Optional[list[str]]:
        s = self.schema()
        return list(s.names) if s is not None else None

    def num_blocks(self) -> int:
        return sum(len(b.metas) for b in self.iter_bundles())

    def size_bytes(self) -> int:
        return sum(b.size_bytes for b in self.iter_bundles())

    def stats(self) -> str:
        bundles = self.materialize()._bundles
        rows = sum(b.num_rows for b in bundles)
        return (
            f"Dataset(plan={self._plan!r}, blocks={sum(len(b.metas) for b in bundles)}, "
            f"rows={rows}, bytes={sum(b.size_bytes for b in bundles)})"
        )

    def to_pandas(self, limit: Optional[int] = None):
        import pandas as pd

        ds = self.limit(limit) if limit is not None else self
        frames = []
        for bundle in ds.iter_bundles():
            for block in ray_tpu_torch.get(bundle.blocks_ref):
                frames.append(BlockAccessor.for_block(block).to_pandas())
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def to_arrow_refs(self) -> list:
        """One ref per bundle to its blocks as ``pyarrow.Table``s (converted
        in a task, which imports pyarrow)."""
        convert = ray_tpu_torch.remote(_blocks_to_arrow)
        return [convert.remote(b.blocks_ref) for b in self.iter_bundles()]

    def materialize(self) -> "MaterializedDataset":
        return MaterializedDataset(list(self.iter_bundles()))

    # -- splits --------------------------------------------------------------

    def split(self, n: int, *, equal: bool = False) -> list["MaterializedDataset"]:
        bundles = list(self.iter_bundles())
        if equal:
            total = sum(b.num_rows for b in bundles)
            per = total // n
            return _split_by_rows(bundles, [per] * n)
        parts: list[list[RefBundle]] = [[] for _ in range(n)]
        for i, b in enumerate(bundles):
            parts[i % n].append(b)
        return [MaterializedDataset(p) for p in parts]

    def train_test_split(self, test_size: float, *, shuffle: bool = False, seed=None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        bundles = list(ds.iter_bundles())
        total = sum(b.num_rows for b in bundles)
        n_test = int(total * test_size) if isinstance(test_size, float) else int(test_size)
        train, test = _split_by_rows(bundles, [total - n_test, n_test])
        return train, test

    def streaming_split(
        self, n: int, *, equal: bool = True, locality_hints=None
    ) -> list[DataIterator]:
        """N coordinated streaming iterators over ONE execution per epoch
        (reference: ``dataset.py:1161``). Safe to consume from n train
        workers concurrently."""
        coord_cls = ray_tpu_torch.remote(SplitCoordinator)
        coord = coord_cls.options(max_concurrency=max(n + 1, 2)).remote(
            self._plan.copy(), n, equal
        )
        return [SplitIterator(coord, i) for i in range(n)]

    # -- writes --------------------------------------------------------------

    def _write(self, path: str, file_format: str, **kwargs) -> list[str]:
        results = []
        remote = ray_tpu_torch.remote(_write_bundle)
        for i, bundle in enumerate(self.iter_bundles()):
            results.append(remote.remote(bundle.blocks_ref, path, file_format, i, kwargs))
        return [p for ps in ray_tpu_torch.get(results) for p in ps]

    def write_parquet(self, path: str, **kwargs):
        return self._write(path, "parquet", **kwargs)

    def write_csv(self, path: str, **kwargs):
        return self._write(path, "csv", **kwargs)

    def write_json(self, path: str, **kwargs):
        return self._write(path, "json", **kwargs)

    def write_numpy(self, path: str, *, column: Optional[str] = None, **kwargs):
        ds = self.select_columns([column]) if column is not None else self
        return ds._write(path, "npy", **kwargs)

    def __repr__(self):
        return f"Dataset({self._plan!r})"

    schema_repr = __repr__


def _map_opts(kwargs: dict) -> dict:
    out = {}
    for k in ("fn_args", "fn_kwargs", "num_cpus", "concurrency", "compute", "fn_constructor_args", "fn_constructor_kwargs"):
        if k in kwargs and kwargs[k] is not None:
            out[k] = kwargs[k]
    if "fn_args" in out:
        out["fn_args"] = tuple(out["fn_args"])
    return out


def _blocks_to_arrow(blocks: list[Block]) -> list:
    return [BlockAccessor.for_block(b).to_arrow() for b in blocks]


def _write_bundle(blocks: list[Block], path: str, file_format: str, index: int, kwargs: dict):
    out = []
    for j, b in enumerate(blocks):
        if BlockAccessor.for_block(b).num_rows():
            out.append(write_block(b, path, file_format, index * 10000 + j, **kwargs))
    return out


def _slice_bundle_rows(bundles: list[RefBundle], start: int, end: int) -> list[RefBundle]:
    """Driver-side row-range selection over materialized bundles."""
    refs = [b.blocks_ref for b in bundles]
    offsets = np.cumsum([0] + [b.num_rows for b in bundles])
    sel = [
        (refs[j], int(offsets[j]))
        for j in range(len(bundles))
        if offsets[j + 1] > start and offsets[j] < end
    ]
    if not sel:
        return []
    base = sel[0][1]
    from ray_tpu_torch.data.exchange import _repartition_reduce

    blocks_ref, meta_ref = (
        ray_tpu_torch.remote(_repartition_reduce)
        .options(num_returns=2)
        .remote(start - base, end - base, *[r for r, _ in sel])
    )
    return [RefBundle(blocks_ref, ray_tpu_torch.get(meta_ref))]


def _split_by_rows(bundles: list[RefBundle], sizes: list[int]) -> list["MaterializedDataset"]:
    out = []
    start = 0
    for s in sizes:
        out.append(MaterializedDataset(_slice_bundle_rows(bundles, start, start + s)))
        start += s
    return out


def _bundles_from_blocks(blocks: list[Block]) -> list[RefBundle]:
    bundles = []
    for b in blocks:
        meta = BlockAccessor.for_block(b).get_metadata()
        bundles.append(RefBundle(ray_tpu_torch.put([b]), [meta]))
    return bundles


class MaterializedDataset(Dataset):
    """A Dataset whose blocks are resident in the object store.

    Reference: ``MaterializedDataset`` in ``dataset.py`` — re-iteration does
    not re-execute the plan.
    """

    def __init__(self, bundles: list[RefBundle]):
        self._bundles = bundles
        super().__init__(L.LogicalPlan([L.InputData(bundles=bundles)]))

    def iter_bundles(self) -> Iterator[RefBundle]:
        yield from self._bundles

    def materialize(self) -> "MaterializedDataset":
        return self


class GroupedData:
    """Reference: ``python/ray/data/grouped_data.py``."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def aggregate(self, *aggs: AggregateFn) -> Dataset:
        return self._ds._with(
            L.AllToAll(kind="aggregate", options={"key": self._key, "aggs": list(aggs)})
        )

    def count(self) -> Dataset:
        return self.aggregate(Count())

    def sum(self, on: str) -> Dataset:
        return self.aggregate(Sum(on))

    def min(self, on: str) -> Dataset:
        return self.aggregate(Min(on))

    def max(self, on: str) -> Dataset:
        return self.aggregate(Max(on))

    def mean(self, on: str) -> Dataset:
        return self.aggregate(Mean(on))

    def std(self, on: str, ddof: int = 1) -> Dataset:
        return self.aggregate(Std(on, ddof))

    def map_groups(self, fn, *, batch_format: str = "numpy") -> Dataset:
        return self._ds._with(
            L.AllToAll(
                kind="map_groups",
                options={"key": self._key, "fn": fn, "batch_format": batch_format},
            )
        )
