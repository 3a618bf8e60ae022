"""Long-tail datasources (port of ``ray_tpu/data/datasource_ext.py``; reference: ``python/ray/data/datasource/`` — the
reference ships 30+ sources; this module is the second tranche on top of
``datasource.py``'s core set).

Design: everything rides the same ``Datasource``/``ReadTask`` API the
streaming executor already consumes. Sources whose client libraries are not
bundled in this image take an injectable client/transport (tested with
fakes, usable with the real library), or gate the import with a clear
error, mirroring ``MongoDatasource``. Formats with a stdlib/pyarrow path
(Avro, ORC, Arrow IPC, WAV, XML, Delta logs) are implemented for real —
the Avro object-container reader is hand-rolled (null/deflate codecs) so
``read_avro`` needs no fastavro.

Avro, WAV, XML, ClickHouse, Databricks and Snowflake (with an injected
transport or connection factory) need no pyarrow. ORC, Arrow IPC/Feather and
Delta import pyarrow where they are used (``ImportError`` naming pyarrow and
the format without it); Lance and Iceberg hand over Arrow tables from their
own packages. Every reader yields numpy-dict blocks.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Callable, Iterator, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata, from_arrow
from ray_tpu_torch.data.datasource import (
    Datasource,
    FileBasedDatasource,
    ParquetDatasource,
    ReadTask,
    SQLDatasource,
    import_pyarrow,
)

# ---------------------------------------------------------------------------
# Avro object container files (reference: datasource/avro_datasource.py,
# which wraps fastavro; hand-rolled here — OCF spec: header map, zigzag
# varints, per-block codec, 16-byte sync markers)
# ---------------------------------------------------------------------------


class _AvroReader:
    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0

    # -- primitives ------------------------------------------------------
    def _byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def read_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self._byte()
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    def read_bytes(self) -> bytes:
        n = self.read_long()
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_utf8(self) -> str:
        return self.read_bytes().decode("utf-8")

    def read_fixed(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    # -- schema-driven decode -------------------------------------------
    def decode(self, schema) -> Any:
        if isinstance(schema, list):  # union: long index + value
            return self.decode(schema[self.read_long()])
        if isinstance(schema, str):
            t = schema
        else:
            t = schema["type"]
        if t == "null":
            return None
        if t == "boolean":
            return self._byte() == 1
        if t in ("int", "long"):
            return self.read_long()
        if t == "float":
            (v,) = struct.unpack("<f", self.read_fixed(4))
            return v
        if t == "double":
            (v,) = struct.unpack("<d", self.read_fixed(8))
            return v
        if t == "bytes":
            return self.read_bytes()
        if t == "string":
            return self.read_utf8()
        if t == "record":
            return {f["name"]: self.decode(f["type"]) for f in schema["fields"]}
        if t == "enum":
            return schema["symbols"][self.read_long()]
        if t == "fixed":
            return self.read_fixed(schema["size"])
        if t == "array":
            out = []
            while True:
                n = self.read_long()
                if n == 0:
                    break
                if n < 0:  # block with byte size prefix
                    n = -n
                    self.read_long()
                out.extend(self.decode(schema["items"]) for _ in range(n))
            return out
        if t == "map":
            out = {}
            while True:
                n = self.read_long()
                if n == 0:
                    break
                if n < 0:
                    n = -n
                    self.read_long()
                for _ in range(n):
                    # key must decode BEFORE the value: in `d[k()] = v()`
                    # Python evaluates the RHS first
                    key = self.read_utf8()
                    out[key] = self.decode(schema["values"])
            return out
        raise ValueError(f"unsupported avro type {t!r}")


def iter_avro_records(data: bytes) -> Iterator[dict]:
    """Decode every record of an Avro object-container file."""
    r = _AvroReader(data)
    if r.read_fixed(4) != b"Obj\x01":
        raise ValueError("not an Avro object container file")
    meta: dict[str, bytes] = {}
    while True:
        n = r.read_long()
        if n == 0:
            break
        if n < 0:
            n = -n
            r.read_long()
        for _ in range(n):
            key = r.read_utf8()  # key BEFORE value (RHS evaluates first)
            meta[key] = r.read_bytes()
    schema = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    sync = r.read_fixed(16)
    while r.pos < len(r.buf):
        count = r.read_long()
        size = r.read_long()
        payload = r.read_fixed(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        block = _AvroReader(payload)
        for _ in range(count):
            yield block.decode(schema)
        if r.read_fixed(16) != sync:
            raise ValueError("avro sync marker mismatch (corrupt file)")


class AvroDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Iterator[Block]:
        with open(path, "rb") as f:
            rows = list(iter_avro_records(f.read()))
        if rows:
            yield BlockAccessor.rows_to_block(rows)


# ---------------------------------------------------------------------------
# ORC + Arrow IPC / Feather (reference: datasource/orc via pyarrow in spirit;
# pyarrow ships both readers)
# ---------------------------------------------------------------------------


class ORCDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Iterator[Block]:
        orc = import_pyarrow("orc", "orc")
        yield from_arrow(orc.read_table(path, columns=self.read_kwargs.get("columns")))


class ArrowIPCDatasource(FileBasedDatasource):
    """Arrow IPC files (a.k.a. Feather v2) and stream format."""

    def _read_file(self, path: str) -> Iterator[Block]:
        pa = import_pyarrow("arrow IPC / feather")
        import_pyarrow("arrow IPC / feather", "ipc")

        with open(path, "rb") as f:
            data = f.read()
        try:
            reader = pa.ipc.open_file(io.BytesIO(data))
            batches = [reader.get_batch(i) for i in range(reader.num_record_batches)]
        except pa.ArrowInvalid:
            batches = list(pa.ipc.open_stream(io.BytesIO(data)))
        for batch in batches:
            yield from_arrow(pa.Table.from_batches([batch]))


# ---------------------------------------------------------------------------
# WAV audio (reference: datasource/audio_datasource.py wraps soundfile;
# stdlib `wave` covers PCM wav without any dependency)
# ---------------------------------------------------------------------------


class AudioDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Iterator[Block]:
        if path.lower().endswith(".wav"):
            import wave

            with wave.open(path, "rb") as w:
                rate = w.getframerate()
                nchan = w.getnchannels()
                width = w.getsampwidth()
                raw = w.readframes(w.getnframes())
            dtype = {1: np.uint8, 2: np.int16, 4: np.int32}.get(width)
            if dtype is None:
                raise ValueError(f"unsupported wav sample width {width}")
            arr = np.frombuffer(raw, dtype=dtype).reshape(-1, nchan)
        else:  # non-wav needs soundfile
            try:
                import soundfile
            except ImportError as e:
                raise ImportError(
                    "read_audio for non-wav formats requires soundfile, which "
                    "is not installed in this environment"
                ) from e
            arr, rate = soundfile.read(path)
            arr = np.atleast_2d(np.asarray(arr).T).T
        # (1, n, ch) numeric batch -> a tensor column (as ImageDatasource's
        # HWC tensors)
        cols = {
            "amplitude": arr[None],
            "sample_rate": np.asarray([rate]),
        }
        if self.read_kwargs.get("include_paths"):
            cols["path"] = np.asarray([path], dtype=object)
        yield BlockAccessor.batch_to_block(cols)


# ---------------------------------------------------------------------------
# XML (row-per-element; stdlib ElementTree)
# ---------------------------------------------------------------------------


class XMLDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Iterator[Block]:
        import xml.etree.ElementTree as ET

        record_tag = self.read_kwargs.get("record_tag")
        root = ET.parse(path).getroot()
        elems = root.iter(record_tag) if record_tag else list(root)
        rows = []
        for el in elems:
            row: dict[str, Any] = dict(el.attrib)
            for child in el:
                row[child.tag] = child.text
            if not row and el.text and el.text.strip():
                row["text"] = el.text.strip()
            if row:
                rows.append(row)
        if rows:
            yield BlockAccessor.rows_to_block(rows)


# ---------------------------------------------------------------------------
# Delta Lake (reference: datasource/delta_sharing_datasource.py + the
# deltalake wrapper). Standalone tier: replay the _delta_log JSON actions to
# the live file set, then read those parquets — no deltalake dependency.
# ---------------------------------------------------------------------------


def _delta_live_files(table_path: str) -> list[str]:
    log_dir = os.path.join(table_path, "_delta_log")
    if not os.path.isdir(log_dir):
        raise FileNotFoundError(f"{table_path!r} has no _delta_log")
    live: dict[str, bool] = {}
    versions = sorted(f for f in os.listdir(log_dir) if f.endswith(".json"))
    if not versions:
        raise FileNotFoundError(f"{log_dir!r} has no commit json")
    for fname in versions:
        with open(os.path.join(log_dir, fname)) as f:
            for line in f:
                if not line.strip():
                    continue
                action = json.loads(line)
                if "add" in action:
                    live[action["add"]["path"]] = True
                elif "remove" in action:
                    live.pop(action["remove"]["path"], None)
    return [os.path.join(table_path, p) for p, ok in live.items() if ok]


class DeltaDatasource(Datasource):
    def __init__(self, table_path: str):
        self._inner = ParquetDatasource(_delta_live_files(table_path))

    def estimate_inmemory_data_size(self):
        return self._inner.estimate_inmemory_data_size()

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        return self._inner.get_read_tasks(parallelism)


# ---------------------------------------------------------------------------
# ClickHouse over its HTTP interface (reference: datasource/clickhouse_
# datasource.py wraps clickhouse-connect). Transport injectable for tests.
# ---------------------------------------------------------------------------


def _http_post(url: str, body: bytes, headers: Optional[dict] = None) -> bytes:
    import urllib.request

    req = urllib.request.Request(url, data=body, headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


class ClickHouseDatasource(Datasource):
    """``query`` runs with ``FORMAT JSONEachRow`` appended; one row per
    JSON line back."""

    def __init__(
        self,
        url: str,
        query: str,
        transport: Callable[[str, bytes], bytes] = None,
    ):
        self._url = url
        self._query = query.rstrip().rstrip(";")
        self._transport = transport or _http_post

    def estimate_inmemory_data_size(self):
        return None

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        url, q, transport = self._url, self._query, self._transport

        def fn():
            raw = transport(url, (q + " FORMAT JSONEachRow").encode())
            rows = [json.loads(ln) for ln in raw.decode().splitlines() if ln.strip()]
            if rows:
                yield BlockAccessor.rows_to_block(rows)

        return [ReadTask(fn, BlockMetadata(None, None))]


# ---------------------------------------------------------------------------
# Databricks SQL warehouses (reference: datasource/databricks_uc_datasource.py
# — REST statement-execution API). Transport injectable for tests.
# ---------------------------------------------------------------------------


class DatabricksDatasource(Datasource):
    def __init__(
        self,
        host: str,
        token: str,
        warehouse_id: str,
        query: str,
        transport: Callable[[str, bytes, dict], bytes] = None,
    ):
        self._host = host.rstrip("/")
        self._token = token
        self._warehouse = warehouse_id
        self._query = query
        self._transport = transport or (
            lambda url, body, headers: _http_post(url, body, headers)
        )

    def estimate_inmemory_data_size(self):
        return None

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        host, token, wh, q, transport = (
            self._host,
            self._token,
            self._warehouse,
            self._query,
            self._transport,
        )

        def fn():
            headers = {
                "Authorization": f"Bearer {token}",
                "Content-Type": "application/json",
            }
            body = json.dumps(
                {
                    "warehouse_id": wh,
                    "statement": q,
                    "wait_timeout": "30s",
                    "format": "JSON_ARRAY",
                    "disposition": "INLINE",
                }
            ).encode()
            resp = json.loads(
                transport(f"{host}/api/2.0/sql/statements/", body, headers).decode()
            )
            state = resp.get("status", {}).get("state")
            if state != "SUCCEEDED":
                raise RuntimeError(f"databricks statement state {state}: {resp}")
            cols = [
                c["name"]
                for c in resp["manifest"]["schema"]["columns"]
            ]
            rows = [dict(zip(cols, r)) for r in resp["result"].get("data_array", [])]
            if rows:
                yield BlockAccessor.rows_to_block(rows)

        return [ReadTask(fn, BlockMetadata(None, None))]


# ---------------------------------------------------------------------------
# Snowflake (reference: datasource/snowflake_datasource.py) — DB-API tier:
# with snowflake-connector installed the connection params work directly;
# any DB-API factory also works (shares SQLDatasource's window machinery).
# ---------------------------------------------------------------------------


def snowflake_datasource(
    query: str,
    connection_factory: Optional[Callable] = None,
    connection_parameters: Optional[dict] = None,
    parallelism_hint: int = 1,
    order_by: Optional[str] = None,
) -> SQLDatasource:
    if connection_factory is None:
        if not connection_parameters:
            raise ValueError(
                "read_snowflake needs connection_factory= or connection_parameters="
            )
        try:
            import snowflake.connector  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "read_snowflake without connection_factory requires "
                "snowflake-connector-python, which is not installed in this "
                "environment; pass connection_factory=... instead"
            ) from e

        def connection_factory():
            import snowflake.connector

            return snowflake.connector.connect(**connection_parameters)

    return SQLDatasource(
        query,
        connection_factory,
        parallelism_hint=parallelism_hint,
        order_by=order_by,
    )


# ---------------------------------------------------------------------------
# Gated imports for formats whose libraries are not in this image
# (reference ships these as first-class sources; the Datasource shim keeps
# the API stable for when the library is present)
# ---------------------------------------------------------------------------


def _gated(name: str, pip_name: str):
    class _Gated(Datasource):
        def __init__(self, *a, **k):
            raise ImportError(
                f"read_{name} requires {pip_name}, which is not installed in "
                f"this environment"
            )

    _Gated.__name__ = f"{name.capitalize()}Datasource"
    return _Gated


class LanceDatasource(Datasource):
    def __init__(self, uri: str, columns=None):
        try:
            import lance
        except ImportError as e:
            raise ImportError(
                "read_lance requires pylance, which is not installed in this "
                "environment"
            ) from e
        self._ds = lance.dataset(uri)
        self._columns = columns

    def estimate_inmemory_data_size(self):
        return None

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        ds, columns = self._ds, self._columns

        def fn():
            yield from_arrow(ds.to_table(columns=columns))

        return [ReadTask(fn, BlockMetadata(None, None))]


class IcebergDatasource(Datasource):
    def __init__(self, table_identifier: str, catalog_kwargs: Optional[dict] = None):
        try:
            from pyiceberg.catalog import load_catalog
        except ImportError as e:
            raise ImportError(
                "read_iceberg requires pyiceberg, which is not installed in "
                "this environment"
            ) from e
        catalog = load_catalog(**(catalog_kwargs or {}))
        self._table = catalog.load_table(table_identifier)

    def estimate_inmemory_data_size(self):
        return None

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        table = self._table

        def fn():
            yield from_arrow(table.scan().to_arrow())

        return [ReadTask(fn, BlockMetadata(None, None))]


HudiDatasource = _gated("hudi", "hudi")


def huggingface_blocks(hf_dataset) -> list:
    """``from_huggingface`` helper: an arrow-backed 🤗 dataset's table as one
    numpy-dict block (gated at the call site on the ``datasets`` package)."""
    table = hf_dataset.data.table if hasattr(hf_dataset.data, "table") else hf_dataset.data
    return [from_arrow(table.combine_chunks())]
