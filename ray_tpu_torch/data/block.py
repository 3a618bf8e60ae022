"""Block layer: the unit of data movement in ray_tpu_torch.data.

Counterpart of ``ray_tpu/data/block.py`` (reference: ``python/ray/data/
block.py``: Block = Arrow table / pandas frame, ``BlockAccessor`` dispatch,
``BlockMetadata``), redesigned for a host without pyarrow or pandas. A block
at rest is a dict of column name -> numpy array, all of one length:

- a tensor column is an n-d array kept as it is (rows along axis 0), with
  no list encoding and no shape metadata;
- strings, bytes and ragged values are 1-d ``object`` arrays (numpy's
  fixed-width ``<U``/``S`` arrays become ``object`` on the way in, so blocks
  of different string widths concatenate);
- pyarrow and pandas are imported only by the conversions that need them:
  ``to_arrow`` / ``to_pandas`` import their package when called, and
  ``batch_to_block`` accepts a ``pyarrow.Table`` or a ``pandas.DataFrame``
  only when that package is already loaded, converting it at once.

``to_numpy_batch`` hands out read-only views (no copy): a block read from
the object store is a zero-copy view of shared memory, which a consumer
must not write into.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Iterable, Iterator, Optional, Union

import numpy as np

TENSOR_COLUMN = "__value__"  # single-column wrapper for bare ndarrays

Block = dict  # str -> np.ndarray at rest
NumpyBatch = dict  # str -> np.ndarray


@dataclass
class BlockMetadata:
    """Sidecar stats carried with every block ref through the plan.

    Reference: ``python/ray/data/block.py`` BlockMetadata (num_rows,
    size_bytes, schema, input_files).
    """

    num_rows: int
    size_bytes: int
    schema: Optional[Any] = None
    input_files: Optional[list[str]] = None


@dataclass(frozen=True)
class Schema:
    """Column names, numpy dtypes and per-row tensor shapes (``()`` for a
    scalar column) — the port's counterpart of the reference's
    ``pyarrow.Schema``."""

    names: tuple
    types: tuple
    shapes: tuple


class BlockAccessor:
    """Uniform view over a block; anything ``batch_to_block`` takes is
    normalized to a numpy dict first."""

    def __init__(self, block):
        self._block = block if _is_block(block) else BlockAccessor.batch_to_block(block)

    @staticmethod
    def for_block(block) -> "BlockAccessor":
        return BlockAccessor(block)

    @property
    def block(self) -> Block:
        return self._block

    # -- construction -------------------------------------------------------

    @staticmethod
    def batch_to_block(batch: Union[Block, NumpyBatch, np.ndarray, Any]) -> Block:
        """Normalize any map_batches return value to a numpy-dict block."""
        if isinstance(batch, np.ndarray):
            batch = {TENSOR_COLUMN: batch}
        if isinstance(batch, dict):
            out: dict[str, np.ndarray] = {}
            n = None
            for k, v in batch.items():
                v = _as_column(v)
                if n is None:
                    n = len(v)
                elif len(v) != n:
                    raise ValueError(
                        f"Batch columns have unequal lengths: {k} has {len(v)}, expected {n}"
                    )
                out[k] = v
            return out
        if "pyarrow" in sys.modules and isinstance(batch, sys.modules["pyarrow"].Table):
            return from_arrow(batch)
        if "pandas" in sys.modules and isinstance(batch, sys.modules["pandas"].DataFrame):
            return {str(c): _as_column(batch[c].to_numpy()) for c in batch.columns}
        raise TypeError(f"Cannot convert {type(batch)} to a block")

    @staticmethod
    def rows_to_block(rows: Iterable[dict]) -> Block:
        rows = list(rows)
        if not rows:
            return {}
        if not isinstance(rows[0], dict):
            rows = [{TENSOR_COLUMN: r} for r in rows]
        cols: dict[str, list] = {k: [] for k in rows[0]}
        for r in rows:
            if set(r) != set(cols):
                raise ValueError(f"Row schema mismatch: {set(r)} vs {set(cols)}")
            for k, v in r.items():
                cols[k].append(v)
        return BlockAccessor.batch_to_block({k: _stack_values(v) for k, v in cols.items()})

    # -- stats --------------------------------------------------------------

    def num_rows(self) -> int:
        b = self._block
        return len(next(iter(b.values()))) if b else 0

    def size_bytes(self) -> int:
        return int(sum(_column_nbytes(v) for v in self._block.values()))

    def schema(self) -> Schema:
        b = self._block
        return Schema(
            names=tuple(b),
            types=tuple(v.dtype for v in b.values()),
            shapes=tuple(tuple(v.shape[1:]) for v in b.values()),
        )

    def get_metadata(self, input_files: Optional[list[str]] = None) -> BlockMetadata:
        return BlockMetadata(
            num_rows=self.num_rows(),
            size_bytes=self.size_bytes(),
            schema=self.schema() if self.num_rows() else None,
            input_files=input_files,
        )

    # -- conversion ---------------------------------------------------------

    def to_arrow(self):
        """A ``pyarrow.Table`` (imports pyarrow): tensor columns become
        FixedSizeList columns with their shape in the schema metadata, as
        the reference stores them."""
        return _table_from_numpy_columns(list(self._block.values()), list(self._block))

    def to_numpy_batch(self) -> NumpyBatch:
        return {k: _readonly(v) for k, v in self._block.items()}

    def to_pandas(self):
        """A ``pandas.DataFrame`` (imports pandas); a tensor column becomes
        an object column of its rows."""
        import pandas as pd

        return pd.DataFrame(
            {k: (list(v) if v.ndim > 1 else v) for k, v in self._block.items()}
        )

    def iter_rows(self) -> Iterator[dict]:
        batch = self.to_numpy_batch()
        keys = list(batch)
        for i in range(self.num_rows()):
            yield {k: _unbox(batch[k][i]) for k in keys}

    # -- ops ----------------------------------------------------------------

    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self._block.items()}

    def take_indices(self, idx: np.ndarray) -> Block:
        idx = np.asarray(idx, dtype=np.int64)
        return {k: v[idx] for k, v in self._block.items()}

    @staticmethod
    def concat(blocks: list) -> Block:
        """Column-wise ``np.concatenate`` of the non-empty blocks. Column
        names must agree and so must each column's dtype and row shape (the
        reference's ``concat_tables`` refuses such a mismatch too); a column
        that is ``object`` in one block and typed in another becomes
        ``object``. All blocks empty: the first one (its columns kept)."""
        accs = [BlockAccessor(b) for b in blocks]
        full = [a.block for a in accs if a.num_rows()]
        if not full:
            return accs[0].block if accs else {}
        if len(full) == 1:
            return full[0]
        names = list(full[0])
        out = {}
        for b in full[1:]:
            if set(b) != set(names):
                raise ValueError(f"concat: blocks have different columns: {names} vs {list(b)}")
        for k in names:
            cols = [b[k] for b in full]
            if any(c.dtype == object for c in cols):
                cols = [c if c.dtype == object else _rows_as_objects(c) for c in cols]
            else:
                first = cols[0]
                for c in cols[1:]:
                    if c.dtype != first.dtype or c.shape[1:] != first.shape[1:]:
                        raise ValueError(
                            f"concat: column {k!r} is {first.dtype}{list(first.shape[1:])} in one "
                            f"block and {c.dtype}{list(c.shape[1:])} in another"
                        )
            out[k] = np.concatenate(cols)
        return out


def from_arrow(table) -> Block:
    """A ``pyarrow.Table`` as a numpy-dict block (FixedSizeList columns with
    the reference's ``tensor_shape`` metadata come back as n-d arrays)."""
    return {name: _as_column(_arrow_col_to_numpy(table, name)) for name in table.column_names}


# -- internals ---------------------------------------------------------------


def _is_block(b) -> bool:
    return isinstance(b, dict) and all(
        isinstance(v, np.ndarray) and v.dtype.kind not in "US" for v in b.values()
    )


def _as_column(v) -> np.ndarray:
    if not isinstance(v, np.ndarray):
        v = _stack_values(list(v)) if isinstance(v, (list, tuple)) else np.asarray(v)
    if v.dtype.kind in "US":
        v = v.astype(object)
    return v


def _stack_values(vals: list) -> np.ndarray:
    """One column from per-row values: a typed (n-d for equal-shaped rows)
    array where numpy makes one, else a 1-d ``object`` array (strings and
    bytes always: numpy's fixed-width ``S`` drops trailing NUL bytes)."""
    if vals and not isinstance(vals[0], (bytes, str)):
        try:
            arr = np.asarray(vals)
            if arr.dtype != object:
                return arr
        except ValueError:  # ragged
            pass
    out = np.empty(len(vals), dtype=object)
    for i, x in enumerate(vals):
        out[i] = np.asarray(x) if isinstance(x, list) else x
    return out


def _rows_as_objects(v: np.ndarray) -> np.ndarray:
    out = np.empty(len(v), dtype=object)
    for i, x in enumerate(v):
        out[i] = _unbox(x)
    return out


def _column_nbytes(v: np.ndarray) -> int:
    if v.dtype != object:
        return v.nbytes
    total = v.nbytes
    for x in v.reshape(-1):
        if isinstance(x, (bytes, bytearray, str)):
            total += len(x)
        elif isinstance(x, np.ndarray):
            total += x.nbytes
        elif x is not None:
            total += sys.getsizeof(x)
    return total


def _readonly(v: np.ndarray) -> np.ndarray:
    if not v.flags.writeable:
        return v
    view = v.view()
    view.flags.writeable = False
    return view


def _table_from_numpy_columns(cols: list[np.ndarray], names: list[str]):
    import pyarrow as pa

    meta: dict[bytes, bytes] = {}
    arrays = []
    for v, name in zip(cols, names):
        if v.ndim > 1 and v.dtype != object:
            # Fixed-shape tensor column → FixedSizeList + shape metadata.
            inner_shape = v.shape[1:]
            size = int(np.prod(inner_shape))
            flat = np.ascontiguousarray(v).reshape(-1)
            arrays.append(pa.FixedSizeListArray.from_arrays(pa.array(flat), size))
            meta[f"tensor_shape:{name}".encode()] = ",".join(map(str, inner_shape)).encode()
        elif v.dtype == object:
            arrays.append(pa.array(v.tolist()))
        else:
            arrays.append(pa.array(v))
    t = pa.Table.from_arrays(arrays, names=names)
    if meta:
        t = t.replace_schema_metadata({**(t.schema.metadata or {}), **meta})
    return t


def _arrow_col_to_numpy(t, name: str) -> np.ndarray:
    import pyarrow as pa

    col = t.column(name)
    if pa.types.is_fixed_size_list(col.type):
        combined = col.combine_chunks()
        if isinstance(combined, pa.ChunkedArray):
            combined = combined.chunk(0) if combined.num_chunks else pa.array([], col.type)
        values = combined.values.to_numpy(zero_copy_only=False)
        width = col.type.list_size
        arr = values.reshape(-1, width)
        shape = _tensor_shape_from_meta(t, name)
        if shape is not None and int(np.prod(shape)) == width:
            arr = arr.reshape((-1,) + tuple(shape))
        return arr
    try:
        return col.to_numpy(zero_copy_only=False)
    except Exception:
        return _stack_values(col.to_pylist())


def _tensor_shape_from_meta(t, name: str):
    meta = t.schema.metadata or {}
    key = f"tensor_shape:{name}".encode()
    if key in meta:
        return tuple(int(x) for x in meta[key].decode().split(",") if x)
    return None


def _unbox(x):
    if isinstance(x, np.generic):
        return x.item()
    return x
