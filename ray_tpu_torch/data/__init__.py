"""ray_tpu_torch.data: lazy distributed datasets feeding torch training
(port of ``ray_tpu/data/__init__.py``).

Reference: ``python/ray/data/__init__.py`` public surface (read_* /
from_* constructors, Dataset, DataIterator, aggregate fns, DataContext).

Blocks are dicts of numpy arrays (``block``); pyarrow and pandas are
imported only by the formats and conversions that need them (parquet, CSV,
ORC, feather, delta, ``from_arrow``, ``from_pandas``, ``to_pandas``), and
torch only by ``iter_torch_batches``: the runtime's forked CPU workers that
run data tasks never start torch or CUDA.
"""

from __future__ import annotations

from typing import Any, Optional

from ray_tpu_torch.data import aggregate  # noqa: F401,E402
from ray_tpu_torch.data.aggregate import AbsMax, AggregateFn, Count, Max, Mean, Min, Std, Sum  # noqa: F401
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata  # noqa: F401
from ray_tpu_torch.data.context import DataContext  # noqa: F401
from ray_tpu_torch.data.dataset import Dataset, GroupedData, MaterializedDataset  # noqa: F401
from ray_tpu_torch.data.datasource import (  # noqa: F401
    BinaryDatasource,
    BlocksDatasource,
    CSVDatasource,
    Datasource,
    FileBasedDatasource,
    ImageDatasource,
    ItemsDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    ReadTask,
    TextDatasource,
    SQLDatasource,
    TFRecordsDatasource,
)
from ray_tpu_torch.data.iterator import DataIterator  # noqa: F401
from ray_tpu_torch.data.plan import LogicalPlan, Read


def _from_source(ds: Datasource, parallelism: int = -1) -> Dataset:
    return Dataset(LogicalPlan([Read(datasource=ds, parallelism=parallelism)]))


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    """ds.range(10) → rows {'id': 0..9} (reference: ``ray.data.range``)."""
    return _from_source(RangeDatasource(n), parallelism)


def range_tensor(n: int, *, shape: tuple = (1,), parallelism: int = -1) -> Dataset:
    return _from_source(RangeDatasource(n, use_tensor=True, tensor_shape=tuple(shape)), parallelism)


def from_items(items: list, *, parallelism: int = -1) -> Dataset:
    return _from_source(ItemsDatasource(list(items)), parallelism)


def from_numpy(arr, *, column: Optional[str] = None) -> Dataset:
    import numpy as np

    from ray_tpu_torch.data.block import TENSOR_COLUMN

    arr = np.asarray(arr)
    block = BlockAccessor.batch_to_block({column or TENSOR_COLUMN: arr})
    return _from_source(BlocksDatasource([block]))


def from_pandas(dfs) -> Dataset:
    """``pandas.DataFrame``(s) -> Dataset, converted to numpy blocks here."""
    import pandas  # noqa: F401 — a DataFrame implies pandas; say so if not

    if not isinstance(dfs, list):
        dfs = [dfs]
    blocks = [BlockAccessor.batch_to_block(df) for df in dfs]
    return _from_source(BlocksDatasource(blocks))


def from_arrow(tables) -> Dataset:
    """``pyarrow.Table``(s) -> Dataset, converted to numpy blocks here."""
    from ray_tpu_torch.data.block import from_arrow as _table_to_block

    if not isinstance(tables, list):
        tables = [tables]
    return _from_source(BlocksDatasource([_table_to_block(t) for t in tables]))


def read_parquet(paths, *, parallelism: int = -1, columns: Optional[list] = None, **kwargs) -> Dataset:
    kw = dict(kwargs)
    if columns is not None:
        kw["columns"] = columns
    return _from_source(ParquetDatasource(paths, kw), parallelism)


def read_csv(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _from_source(CSVDatasource(paths, kwargs), parallelism)


def read_json(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _from_source(JSONDatasource(paths, kwargs), parallelism)


def read_text(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _from_source(TextDatasource(paths, kwargs), parallelism)


def read_binary_files(paths, *, include_paths: bool = False, parallelism: int = -1, **kwargs) -> Dataset:
    return _from_source(BinaryDatasource(paths, {"include_paths": include_paths, **kwargs}), parallelism)


def read_images(paths, *, size=None, mode: str = "RGB", include_paths: bool = False, parallelism: int = -1) -> Dataset:
    return _from_source(
        ImageDatasource(paths, {"size": size, "mode": mode, "include_paths": include_paths}),
        parallelism,
    )


def read_numpy(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _from_source(NumpyDatasource(paths, kwargs), parallelism)


def read_tfrecords(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return _from_source(TFRecordsDatasource(paths, kwargs), parallelism)


def read_sql(
    sql: str, connection_factory, *, parallelism: int = 1, order_by: str = None
) -> Dataset:
    """Rows of a SQL query as a Dataset (reference: ``ray.data.read_sql``).
    ``connection_factory`` is a zero-arg callable returning a DB-API
    connection (sqlite3.connect, psycopg2.connect, ...). ``parallelism > 1``
    windows the query with LIMIT/OFFSET and requires ``order_by`` (a
    deterministic ordering key) so windows are disjoint."""
    return _from_source(
        SQLDatasource(
            sql, connection_factory, parallelism_hint=parallelism, order_by=order_by
        ),
        parallelism,
    )


def read_webdataset(paths, *, parallelism: int = -1, decode: bool = True, **kwargs) -> Dataset:
    """WebDataset tar shards -> one row per sample (reference:
    ``ray.data.read_webdataset``); columns are member extensions."""
    from ray_tpu_torch.data.datasource import WebDatasetDatasource

    return read_datasource(
        WebDatasetDatasource(paths, {"decode": decode, **kwargs}), parallelism=parallelism
    )


def read_mongo(uri: str, database: str, collection: str, *, pipeline=None, parallelism: int = -1) -> Dataset:
    """MongoDB collection -> Dataset (reference: ``ray.data.read_mongo``).
    Needs pymongo installed."""
    from ray_tpu_torch.data.datasource import MongoDatasource

    return read_datasource(
        MongoDatasource(uri, database, collection, pipeline), parallelism=parallelism
    )


def read_bigquery(project_id: str, *, query: str = None, dataset: str = None, parallelism: int = -1) -> Dataset:
    """BigQuery query/table -> Dataset (reference: ``ray.data.read_bigquery``).
    Needs google-cloud-bigquery installed."""
    from ray_tpu_torch.data.datasource import BigQueryDatasource

    return read_datasource(
        BigQueryDatasource(project_id, query, dataset), parallelism=parallelism
    )


def read_datasource(datasource: Datasource, *, parallelism: int = -1) -> Dataset:
    return _from_source(datasource, parallelism)


# ---------------------------------------------------------------------------
# long-tail sources (datasource_ext.py; reference datasource/ second tranche)
# ---------------------------------------------------------------------------


def read_avro(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    """Avro object-container files -> Dataset (reference:
    ``ray.data.read_avro``). Hand-rolled OCF reader — no fastavro needed
    (null + deflate codecs)."""
    from ray_tpu_torch.data.datasource_ext import AvroDatasource

    return _from_source(AvroDatasource(paths, kwargs), parallelism)


def read_orc(paths, *, parallelism: int = -1, columns: Optional[list] = None, **kwargs) -> Dataset:
    """ORC files via pyarrow.orc (reference: arrow-backed ORC reads)."""
    from ray_tpu_torch.data.datasource_ext import ORCDatasource

    kw = dict(kwargs)
    if columns is not None:
        kw["columns"] = columns
    return _from_source(ORCDatasource(paths, kw), parallelism)


def read_feather(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    """Arrow IPC / Feather v2 files (file or stream format)."""
    from ray_tpu_torch.data.datasource_ext import ArrowIPCDatasource

    return _from_source(ArrowIPCDatasource(paths, kwargs), parallelism)


read_arrow_ipc = read_feather


def read_audio(paths, *, include_paths: bool = False, parallelism: int = -1) -> Dataset:
    """Audio files -> rows of {amplitude, sample_rate} (reference:
    ``ray.data.read_audio``). WAV decodes with the stdlib; other formats
    need soundfile."""
    from ray_tpu_torch.data.datasource_ext import AudioDatasource

    return _from_source(
        AudioDatasource(paths, {"include_paths": include_paths}), parallelism
    )


def read_xml(paths, *, record_tag: str = None, parallelism: int = -1) -> Dataset:
    """XML documents -> one row per record element (attributes + child
    element text become columns)."""
    from ray_tpu_torch.data.datasource_ext import XMLDatasource

    return _from_source(XMLDatasource(paths, {"record_tag": record_tag}), parallelism)


def read_delta(table_path: str, *, parallelism: int = -1) -> Dataset:
    """Delta Lake table -> Dataset by replaying the ``_delta_log`` JSON
    commit actions to the live parquet file set (reference: the deltalake-
    wrapped source; this tier needs no deltalake package)."""
    from ray_tpu_torch.data.datasource_ext import DeltaDatasource

    return _from_source(DeltaDatasource(table_path), parallelism)


def read_clickhouse(url: str, query: str, *, transport=None, parallelism: int = -1) -> Dataset:
    """ClickHouse over its HTTP interface, ``FORMAT JSONEachRow``
    (reference: ``ray.data.read_clickhouse``). ``transport`` is injectable
    for tests / custom auth."""
    from ray_tpu_torch.data.datasource_ext import ClickHouseDatasource

    return read_datasource(
        ClickHouseDatasource(url, query, transport), parallelism=parallelism
    )


def read_databricks_tables(
    *, host: str, token: str, warehouse_id: str, query: str, transport=None,
    parallelism: int = -1,
) -> Dataset:
    """Databricks SQL warehouse statement-execution API (reference:
    ``ray.data.read_databricks_tables``)."""
    from ray_tpu_torch.data.datasource_ext import DatabricksDatasource

    return read_datasource(
        DatabricksDatasource(host, token, warehouse_id, query, transport),
        parallelism=parallelism,
    )


def read_snowflake(
    query: str, *, connection_factory=None, connection_parameters: dict = None,
    parallelism: int = 1, order_by: str = None,
) -> Dataset:
    """Snowflake -> Dataset (reference: ``ray.data.read_snowflake``): pass
    ``connection_parameters`` with snowflake-connector installed, or any
    DB-API ``connection_factory`` (shares read_sql's window machinery)."""
    from ray_tpu_torch.data.datasource_ext import snowflake_datasource

    return _from_source(
        snowflake_datasource(
            query, connection_factory, connection_parameters,
            parallelism_hint=parallelism, order_by=order_by,
        ),
        parallelism,
    )


def read_lance(uri: str, *, columns=None, parallelism: int = -1) -> Dataset:
    """Lance datasets (reference: ``ray.data.read_lance``). Needs pylance."""
    from ray_tpu_torch.data.datasource_ext import LanceDatasource

    return read_datasource(LanceDatasource(uri, columns), parallelism=parallelism)


def read_iceberg(table_identifier: str, *, catalog_kwargs: dict = None, parallelism: int = -1) -> Dataset:
    """Iceberg tables (reference: ``ray.data.read_iceberg``). Needs pyiceberg."""
    from ray_tpu_torch.data.datasource_ext import IcebergDatasource

    return read_datasource(
        IcebergDatasource(table_identifier, catalog_kwargs), parallelism=parallelism
    )


def read_hudi(table_uri: str, *, parallelism: int = -1) -> Dataset:
    """Hudi tables (reference: ``ray.data.read_hudi``). Needs the hudi package."""
    from ray_tpu_torch.data.datasource_ext import HudiDatasource

    return read_datasource(HudiDatasource(table_uri), parallelism=parallelism)


def read_parquet_bulk(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    """Many small parquet files without per-file metadata fetches
    (reference: ``ray.data.read_parquet_bulk`` — same reader here, the
    distinction is advisory)."""
    return read_parquet(paths, parallelism=parallelism, **kwargs)


def from_huggingface(hf_dataset) -> Dataset:
    """An arrow-backed 🤗 ``datasets.Dataset`` -> Dataset (reference:
    ``ray.data.from_huggingface``): the underlying arrow table as one numpy
    block."""
    from ray_tpu_torch.data.datasource_ext import huggingface_blocks

    return _from_source(BlocksDatasource(huggingface_blocks(hf_dataset)))
