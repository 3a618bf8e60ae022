"""Datasources: pluggable readers/writers producing blocks (port of
``ray_tpu/data/datasource.py``).

Reference: ``python/ray/data/datasource/`` (Datasource ABC + ReadTask;
parquet/csv/json/images/binary/range readers, write API). A ``ReadTask`` is
a zero-arg callable returning an iterator of blocks; the executor runs each
as a remote task, so reads parallelize across the cluster exactly like the
reference's.

Every reader yields numpy-dict blocks. Parquet and CSV (reading and
writing) need pyarrow and import it where they are used; without it they
raise ``ImportError`` naming pyarrow and the format. JSON lines are read and
written with the standard library. Images need PIL, imported where they are
read.
"""

from __future__ import annotations

import glob as _glob
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

from ray_tpu_torch.data.block import (
    TENSOR_COLUMN,
    Block,
    BlockAccessor,
    BlockMetadata,
    _stack_values,
    from_arrow,
)


@dataclass
class ReadTask:
    """One parallel unit of reading. ``fn`` runs inside a remote task."""

    fn: Callable[[], Iterable[Block]]
    metadata: BlockMetadata

    def __call__(self) -> Iterable[Block]:
        return self.fn()


class Datasource:
    """Reference: ``python/ray/data/datasource/datasource.py``."""

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None

    @property
    def name(self) -> str:
        return type(self).__name__.replace("Datasource", "")


class RangeDatasource(Datasource):
    def __init__(self, n: int, use_tensor: bool = False, tensor_shape: tuple = ()):
        self._n = n
        self._use_tensor = use_tensor
        self._tensor_shape = tensor_shape

    def estimate_inmemory_data_size(self):
        return self._n * 8 * max(1, int(np.prod(self._tensor_shape or (1,))))

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        parallelism = max(1, min(parallelism, self._n or 1))
        tasks = []
        per = -(-self._n // parallelism) if self._n else 0
        for i in range(parallelism):
            start, end = i * per, min((i + 1) * per, self._n)
            if start >= end and self._n:
                break
            use_tensor, shape = self._use_tensor, self._tensor_shape

            def fn(start=start, end=end):
                ids = np.arange(start, end, dtype=np.int64)
                if use_tensor:
                    data = np.broadcast_to(
                        ids.reshape((-1,) + (1,) * len(shape)), (len(ids),) + shape
                    ).copy()
                    yield BlockAccessor.batch_to_block({"data": data})
                else:
                    yield BlockAccessor.batch_to_block({"id": ids})

            meta = BlockMetadata(num_rows=end - start, size_bytes=(end - start) * 8)
            tasks.append(ReadTask(fn, meta))
        return tasks or [ReadTask(lambda: iter(()), BlockMetadata(0, 0))]


class ItemsDatasource(Datasource):
    def __init__(self, items: list):
        self._items = items

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        items = self._items
        n = len(items)
        parallelism = max(1, min(parallelism, n or 1))
        per = -(-n // parallelism) if n else 0
        tasks = []
        for i in range(parallelism):
            chunk = items[i * per : (i + 1) * per]
            if not chunk and n:
                break

            def fn(chunk=chunk):
                if chunk and isinstance(chunk[0], dict):
                    yield BlockAccessor.rows_to_block(chunk)
                else:
                    yield BlockAccessor.rows_to_block([{"item": x} for x in chunk])

            tasks.append(ReadTask(fn, BlockMetadata(num_rows=len(chunk), size_bytes=0)))
        return tasks or [ReadTask(lambda: iter(()), BlockMetadata(0, 0))]


class BlocksDatasource(Datasource):
    """Wraps already-materialized blocks (from_numpy/from_pandas/from_arrow)."""

    def __init__(self, blocks: list[Block]):
        self._blocks = blocks

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        tasks = []
        for b in self._blocks:
            acc = BlockAccessor.for_block(b)
            tasks.append(ReadTask(lambda b=b: [BlockAccessor.batch_to_block(b)], acc.get_metadata()))
        return tasks


# -- file-based sources ------------------------------------------------------


def _expand_paths(paths) -> list[str]:
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out: list[str] = []
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs.sort()  # deterministic traversal order across filesystems
                out.extend(os.path.join(root, f) for f in sorted(files) if not f.startswith("."))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"No input files found for {paths!r}")
    return out


@dataclass
class FileBasedDatasource(Datasource):
    """Reference: ``python/ray/data/datasource/file_based_datasource.py``."""

    paths: Any
    read_kwargs: dict = field(default_factory=dict)

    def __post_init__(self):
        self._files = _expand_paths(self.paths)

    def _read_file(self, path: str) -> Iterator[Block]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self):
        try:
            return sum(os.path.getsize(f) for f in self._files)
        except OSError:
            return None

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        files = self._files
        parallelism = max(1, min(parallelism, len(files)))
        per = -(-len(files) // parallelism)
        tasks = []
        for i in range(parallelism):
            chunk = files[i * per : (i + 1) * per]
            if not chunk:
                break

            def fn(chunk=chunk, self=self):
                for path in chunk:
                    yield from self._read_file(path)

            size = sum(os.path.getsize(f) for f in chunk if os.path.exists(f))
            tasks.append(
                ReadTask(fn, BlockMetadata(num_rows=0, size_bytes=size, input_files=chunk))
            )
        return tasks


def import_pyarrow(fmt: str, submodule: Optional[str] = None):
    """``pyarrow`` (or ``pyarrow.<submodule>``) for a format that needs it;
    without it an ``ImportError`` naming pyarrow and the format."""
    import importlib

    name = "pyarrow" if submodule is None else f"pyarrow.{submodule}"
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(
            f"{fmt} needs pyarrow, which is not installed in this environment "
            f"(the numpy, text, binary, TFRecords, Avro and JSON-lines formats need none)"
        ) from e


class ParquetDatasource(FileBasedDatasource):
    def _read_file(self, path):
        pq = import_pyarrow("parquet", "parquet")
        columns = self.read_kwargs.get("columns")
        f = pq.ParquetFile(path)
        for rg in range(f.num_row_groups):
            yield from_arrow(f.read_row_group(rg, columns=columns))


class CSVDatasource(FileBasedDatasource):
    def _read_file(self, path):
        csv = import_pyarrow("csv", "csv")
        yield from_arrow(csv.read_csv(path, **self.read_kwargs))


class JSONDatasource(FileBasedDatasource):
    """Newline-delimited JSON, one row per line (and a plain JSON array or
    object as a whole file), parsed with the standard library: the
    reference's pyarrow reader and its options are not used."""

    def _read_file(self, path):
        import json as _json

        if self.read_kwargs:
            raise TypeError(f"read_json takes no reader options here, got {sorted(self.read_kwargs)}")
        with open(path) as f:
            text = f.read()
        try:
            rows = [_json.loads(ln) for ln in text.splitlines() if ln.strip()]
        except ValueError:  # a JSON document over several lines
            rows = [_json.loads(text)]
        if len(rows) == 1 and isinstance(rows[0], list):
            rows = rows[0]
        if rows:
            yield BlockAccessor.rows_to_block(rows)


class TextDatasource(FileBasedDatasource):
    def _read_file(self, path):
        drop_empty = self.read_kwargs.get("drop_empty_lines", True)
        with open(path, encoding=self.read_kwargs.get("encoding", "utf-8")) as f:
            lines = [ln.rstrip("\n") for ln in f]
        if drop_empty:
            lines = [ln for ln in lines if ln]
        yield BlockAccessor.batch_to_block({"text": np.asarray(lines, dtype=object)})


class BinaryDatasource(FileBasedDatasource):
    def _read_file(self, path):
        with open(path, "rb") as f:
            data = f.read()
        cols = {"bytes": np.asarray([data], dtype=object)}
        if self.read_kwargs.get("include_paths"):
            cols["path"] = np.asarray([path], dtype=object)
        yield BlockAccessor.batch_to_block(cols)


class ImageDatasource(FileBasedDatasource):
    """Decodes images into a fixed-shape tensor column (HWC uint8/float32)."""

    def _read_file(self, path):
        from PIL import Image

        size = self.read_kwargs.get("size")
        mode = self.read_kwargs.get("mode", "RGB")
        img = Image.open(path).convert(mode)
        if size is not None:
            img = img.resize((size[1], size[0]))
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        cols = {"image": arr[None]}
        if self.read_kwargs.get("include_paths"):
            cols["path"] = np.asarray([path], dtype=object)
        yield BlockAccessor.batch_to_block(cols)


class NumpyDatasource(FileBasedDatasource):
    def _read_file(self, path):
        arr = np.load(path, allow_pickle=False)
        yield BlockAccessor.batch_to_block({self.read_kwargs.get("column", TENSOR_COLUMN): arr})


class TFRecordsDatasource(FileBasedDatasource):
    """Minimal TFRecord reader (uncompressed) → tf.train.Example features.

    Pure-python record framing (length/crc framing per the TFRecord spec);
    requires no tensorflow. Feature decode supports bytes/float/int64 lists.
    """

    def _read_file(self, path):
        rows = []
        for rec in _iter_tfrecords(path):
            rows.append(_parse_tf_example(rec))
        if rows:
            yield BlockAccessor.rows_to_block(rows)


def _iter_tfrecords(path: str) -> Iterator[bytes]:
    import struct

    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.read(4)  # length crc
            data = f.read(length)
            f.read(4)  # data crc
            yield data


def _parse_tf_example(data: bytes) -> dict:
    """Hand-rolled protobuf walk of tf.train.Example (features map)."""
    out: dict[str, Any] = {}
    feats = _pb_find(data, 1)
    for item in _pb_repeated(feats, 1):
        key = _pb_find(item, 1).decode()
        feature = _pb_find(item, 2)
        for tag in (1, 2, 3):  # bytes_list / float_list / int64_list
            lst = _pb_find(feature, tag)
            if lst is not None:
                vals = _pb_list_values(lst, tag)
                out[key] = vals[0] if len(vals) == 1 else vals
                break
    return out


def _signed64(x: int) -> int:
    # Protobuf varints carry int64 as two's complement in 64 bits.
    return x - (1 << 64) if x >= (1 << 63) else x


def _pb_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = val = 0
    while True:
        b = buf[i]
        val |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return val, i
        shift += 7


def _pb_walk(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _pb_varint(buf, i)
        tag, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _pb_varint(buf, i)
        elif wire == 2:
            ln, i = _pb_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        elif wire == 5:
            val = buf[i : i + 4]
            i += 4
        elif wire == 1:
            val = buf[i : i + 8]
            i += 8
        else:
            raise ValueError(f"bad wire type {wire}")
        yield tag, wire, val


def _pb_find(buf: bytes, tag: int):
    if buf is None:
        return None
    for t, _, v in _pb_walk(buf):
        if t == tag:
            return v
    return None


def _pb_repeated(buf: bytes, tag: int):
    if buf is None:
        return
    for t, _, v in _pb_walk(buf):
        if t == tag:
            yield v


def _pb_list_values(buf: bytes, kind: int) -> list:
    import struct

    vals: list = []
    for t, wire, v in _pb_walk(buf):
        if t != 1:
            continue
        if kind == 1:
            vals.append(v)
        elif kind == 2:
            if wire == 2:  # packed floats
                vals.extend(struct.unpack(f"<{len(v)//4}f", v))
            else:
                vals.append(struct.unpack("<f", v)[0])
        else:
            if wire == 2:  # packed varints
                i = 0
                while i < len(v):
                    x, i = _pb_varint(v, i)
                    vals.append(_signed64(x))
            else:
                vals.append(_signed64(v))
    return vals


# -- write side --------------------------------------------------------------


def write_block(block: Block, path: str, file_format: str, index: int, **kwargs) -> str:
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{index:06d}.{file_format}")
    if file_format == "parquet":
        pq = import_pyarrow("write_parquet", "parquet")
        pq.write_table(BlockAccessor.for_block(block).to_arrow(), out, **kwargs)
    elif file_format == "csv":
        csv = import_pyarrow("write_csv", "csv")
        csv.write_csv(BlockAccessor.for_block(block).to_arrow(), out)
    elif file_format == "json":
        import json

        with open(out, "w") as f:
            for row in BlockAccessor.for_block(block).iter_rows():
                f.write(json.dumps({k: _json_safe(v) for k, v in row.items()}) + "\n")
    elif file_format == "npy":
        batch = BlockAccessor.for_block(block).to_numpy_batch()
        if len(batch) != 1:
            raise ValueError("write_numpy requires a single-column dataset")
        np.save(out, next(iter(batch.values())))
    else:
        raise ValueError(f"Unsupported format {file_format}")
    return out


def _json_safe(v):
    if isinstance(v, (np.ndarray,)):
        return v.tolist()
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.generic):
        return v.item()
    return v


class WebDatasetDatasource(FileBasedDatasource):
    """WebDataset tar shards (reference: ``datasource/webdataset_datasource.py``).

    Each sample = consecutive tar members sharing a basename; member
    extensions become columns (``jpg``/``png`` decode to image tensors when
    PIL is available and ``decode=True``, ``json`` parses, ``cls``/``txt``
    decode to scalars, everything else stays bytes). Pure tarfile — no
    webdataset dependency.
    """

    def _read_file(self, path):
        import json as _json
        import tarfile

        decode = self.read_kwargs.get("decode", True)
        rows: list[dict] = []
        with tarfile.open(path) as tf:
            current_key = None
            sample: dict = {}
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name
                base, dot, ext = name.partition(".")
                if current_key is not None and base != current_key and sample:
                    rows.append(sample)
                    sample = {}
                current_key = base
                data = tf.extractfile(member).read()
                if decode:
                    if ext in ("txt", "text"):
                        data = data.decode()
                    elif ext in ("cls", "id", "index"):
                        data = int(data)
                    elif ext == "json":
                        data = _json.loads(data)
                    elif ext in ("jpg", "jpeg", "png") :
                        try:
                            import io as _io

                            from PIL import Image

                            data = np.asarray(Image.open(_io.BytesIO(data)))
                        except ImportError:
                            pass  # leave raw bytes
                sample["__key__"] = base
                sample[ext] = data
            if sample:
                rows.append(sample)
        if rows:
            yield BlockAccessor.rows_to_block(rows)


class MongoDatasource(Datasource):
    """MongoDB collections (reference: ``datasource/mongo_datasource.py``).
    Requires ``pymongo`` (not bundled — gated import)."""

    def __init__(self, uri: str, database: str, collection: str, pipeline=None):
        try:
            import pymongo  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "read_mongo requires pymongo, which is not installed in this "
                "environment"
            ) from e
        self.uri, self.database, self.collection = uri, database, collection
        self.pipeline = pipeline or []

    def estimate_inmemory_data_size(self):
        return None

    def get_read_tasks(self, parallelism: int) -> list:
        uri, db, coll, pipe = self.uri, self.database, self.collection, self.pipeline

        def fn():
            import pymongo

            client = pymongo.MongoClient(uri)
            docs = list(client[db][coll].aggregate(pipe) if pipe else client[db][coll].find())
            for d in docs:
                d.pop("_id", None)
            if docs:
                yield BlockAccessor.rows_to_block(docs)

        return [ReadTask(fn, BlockMetadata(num_rows=0, size_bytes=None, input_files=[]))]


class BigQueryDatasource(Datasource):
    """BigQuery tables/queries (reference: ``datasource/bigquery_datasource.py``).
    Requires ``google-cloud-bigquery`` (gated import)."""

    def __init__(self, project_id: str, query: Optional[str] = None, dataset: Optional[str] = None):
        try:
            from google.cloud import bigquery  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "read_bigquery requires google-cloud-bigquery, which is not "
                "installed in this environment"
            ) from e
        if not (query or dataset):
            raise ValueError(
                "read_bigquery needs query=... or dataset=... "
                "(dataset must be a fully-qualified table id: "
                "'project.dataset.table')"
            )
        self.project_id, self.query, self.dataset = project_id, query, dataset

    def estimate_inmemory_data_size(self):
        return None

    def get_read_tasks(self, parallelism: int) -> list:
        project, query, dataset = self.project_id, self.query, self.dataset

        def fn():
            from google.cloud import bigquery

            client = bigquery.Client(project=project)
            if query:
                table = client.query(query).to_arrow()
            else:
                table = client.list_rows(dataset).to_arrow()
            yield from_arrow(table)

        return [ReadTask(fn, BlockMetadata(num_rows=0, size_bytes=None, input_files=[]))]


class SQLDatasource(Datasource):
    """Rows from a SQL query via a DB-API connection factory.

    Reference: ``python/ray/data/datasource/sql_datasource.py`` (``read_sql``
    takes a query + zero-arg connection factory; works with sqlite3,
    psycopg2, mysql-connector — anything DB-API 2.0). Parallelism: the query
    runs once per read task with LIMIT/OFFSET windows when ``parallelism > 1``
    (like the reference's sharded reads); drivers without cheap OFFSET can
    pass ``parallelism=1``.
    """

    def __init__(
        self,
        sql: str,
        connection_factory,
        parallelism_hint: int = 1,
        order_by: Optional[str] = None,
    ):
        self._sql = sql
        self._factory = connection_factory
        self._hint = parallelism_hint
        self._order_by = order_by
        if parallelism_hint > 1 and not order_by:
            # LIMIT/OFFSET windows over an UNORDERED query re-executed per
            # task are not disjoint on engines with nondeterministic scan
            # order (observed on PostgreSQL parallel seq scans) — rows would
            # silently duplicate/vanish. Force the caller to choose the key.
            raise ValueError(
                "read_sql with parallelism > 1 needs order_by= (a column list "
                "giving a deterministic total order) so OFFSET windows are "
                "disjoint across read tasks"
            )

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        sql, factory, order_by = self._sql, self._factory, self._order_by
        parallelism = max(1, min(parallelism, self._hint))

        def run_query(window=None):
            def fn():
                conn = factory()
                try:
                    cur = conn.cursor()
                    if window is None:
                        q = sql
                    else:
                        q = (
                            f"SELECT * FROM ({sql}) AS _t ORDER BY {order_by} "
                            f"LIMIT {window[1]} OFFSET {window[0]}"
                        )
                    cur.execute(q)
                    cols = [d[0] for d in cur.description]
                    rows = cur.fetchall()
                    if rows:
                        data = {c: _stack_values([r[i] for r in rows]) for i, c in enumerate(cols)}
                        yield BlockAccessor.batch_to_block(data)
                finally:
                    conn.close()

            return fn

        if parallelism == 1:
            return [ReadTask(run_query(), BlockMetadata(None, None))]
        # window the query; an extra tail task catches the remainder
        conn = factory()
        try:
            cur = conn.cursor()
            cur.execute(f"SELECT COUNT(*) FROM ({sql}) AS _t")
            total = int(cur.fetchone()[0])
        finally:
            conn.close()
        per = -(-total // parallelism)
        tasks = []
        for i in range(parallelism):
            start = i * per
            if start >= total:
                break
            tasks.append(
                ReadTask(run_query((start, per)), BlockMetadata(min(per, total - start), None))
            )
        return tasks or [ReadTask(run_query(), BlockMetadata(0, 0))]
