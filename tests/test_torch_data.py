"""The port's Data against the reference's tests: a mirror of
``tests/test_data.py`` run on ``ray_tpu_torch.data`` (block ops,
transformations and fusion, all-to-all exchanges, datasources, iteration
with ``iter_torch_batches`` in place of ``iter_jax_batches``, splits,
groupby, writes), the data tests of ``tests/test_streaming_generators.py``
and ``tests/test_chaos.py``, the numpy-dict block's own edge cases, and
``TorchTrainer`` fed a Dataset. The runtime is shared by the module."""

import struct
import threading

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch.data.block import BlockAccessor, Schema


@pytest.fixture(scope="module")
def _shared_cluster():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_regular(_shared_cluster):
    yield


# -- mirror of tests/test_data.py -------------------------------------------


def test_range_count_take(ray_start_regular):
    ds = rd.range(100, parallelism=5)
    assert ds.count() == 100
    assert ds.take(3) == [{"id": 0}, {"id": 1}, {"id": 2}]
    assert len(ds.take_all()) == 100


def test_map_batches_fusion_and_formats(ray_start_regular):
    ds = rd.range(64, parallelism=4)
    out = (
        ds.map_batches(lambda b: {"id": b["id"] * 2})
        .map_batches(lambda b: {"id": b["id"] + 1})
        .sum("id")
    )
    assert out == sum(2 * i + 1 for i in range(64))

    def pdf(df):
        df["id"] = df["id"] * 3
        return df

    assert rd.range(10).map_batches(pdf, batch_format="pandas").sum("id") == 3 * 45
    assert rd.range(10).map_batches(lambda t: t, batch_format="pyarrow").count() == 10


def test_map_batches_batch_size_rebatching(ray_start_regular):
    def record(b):
        assert len(b["id"]) <= 32
        return b

    ds = rd.range(100, parallelism=7).map_batches(record, batch_size=32)
    assert ds.count() == 100


def test_map_filter_flatmap(ray_start_regular):
    ds = rd.range(20, parallelism=3)
    assert ds.map(lambda r: {"x": r["id"] ** 2}).take(3) == [{"x": 0}, {"x": 1}, {"x": 4}]
    assert ds.filter(lambda r: r["id"] < 5).count() == 5
    assert ds.flat_map(lambda r: [{"y": r["id"]}, {"y": -r["id"]}]).count() == 40


def test_column_ops(ray_start_regular):
    ds = rd.range(10).add_column("double", lambda b: b["id"] * 2)
    row = ds.take(1)[0]
    assert row == {"id": 0, "double": 0}
    assert ds.select_columns(["double"]).columns() == ["double"]
    assert ds.drop_columns(["double"]).columns() == ["id"]
    assert ds.rename_columns({"id": "idx"}).columns() == ["idx", "double"]


def test_limit_early_stop(ray_start_regular):
    rows = rd.range(10_000, parallelism=16).limit(25).take_all()
    assert [r["id"] for r in rows] == list(range(25))


def test_sort_shuffle_repartition(ray_start_regular):
    ds = rd.range(200, parallelism=8)
    got = [r["id"] for r in ds.sort("id", descending=True).take_all()]
    assert got == sorted(range(200), reverse=True)
    shuffled = [r["id"] for r in ds.random_shuffle(seed=42).take_all()]
    assert shuffled != list(range(200)) and sorted(shuffled) == list(range(200))
    assert ds.repartition(5).num_blocks() == 5


def test_union_zip(ray_start_regular):
    a = rd.range(10, parallelism=2)
    b = rd.range(10, parallelism=2).map(lambda r: {"id": r["id"] + 10})
    assert a.union(b).count() == 20
    z = a.zip(rd.range(10, parallelism=3).map(lambda r: {"v": r["id"] * 2}))
    rows = sorted(z.take_all(), key=lambda r: r["id"])
    assert rows[3] == {"id": 3, "v": 6}


def test_groupby_aggregations(ray_start_regular):
    ds = rd.range(90, parallelism=6).map(lambda r: {"k": r["id"] % 3, "v": float(r["id"])})
    counts = {r["k"]: r["count()"] for r in ds.groupby("k").count().take_all()}
    assert counts == {0: 30, 1: 30, 2: 30}
    means = {r["k"]: r["mean(v)"] for r in ds.groupby("k").mean("v").take_all()}
    assert means[0] == pytest.approx(np.mean(np.arange(0, 90, 3)))
    assert ds.min("v") == 0 and ds.max("v") == 89
    assert ds.std("v") == pytest.approx(np.std(np.arange(90), ddof=1))


def test_map_groups(ray_start_regular):
    ds = rd.range(30).map(lambda r: {"k": r["id"] % 3, "v": r["id"]})
    out = ds.groupby("k").map_groups(lambda g: {"k": g["k"][:1], "total": [g["v"].sum()]})
    rows = sorted(out.take_all(), key=lambda r: r["k"])
    assert rows[0]["total"] == sum(range(0, 30, 3))


def test_actor_compute_map_batches(ray_start_regular):
    class AddN:
        def __init__(self, n):
            self.n = n

        def __call__(self, batch):
            return {"id": batch["id"] + self.n}

    ds = rd.range(40, parallelism=4).map_batches(AddN, fn_constructor_args=(100,), concurrency=2)
    assert ds.sum("id") == sum(range(40)) + 100 * 40


def test_tensor_columns(ray_start_regular):
    arr = np.arange(60, dtype=np.float32).reshape(10, 2, 3)
    ds = rd.from_numpy(arr, column="x")
    batch = ds.take_batch(10, batch_format="numpy")
    assert batch["x"].shape == (10, 2, 3)
    np.testing.assert_array_equal(batch["x"], arr)
    out = ds.map_batches(lambda b: {"x": b["x"] * 2}).take_batch(10)
    np.testing.assert_array_equal(out["x"], arr * 2)
    assert ds.schema() == Schema(names=("x",), types=(np.dtype(np.float32),), shapes=((2, 3),))


def test_from_pandas_arrow_items(ray_start_regular):
    import pandas as pd
    import pyarrow as pa

    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    assert rd.from_pandas(df).count() == 3
    assert rd.from_arrow(pa.Table.from_pandas(df)).take(1)[0]["a"] == 1
    assert rd.from_items([{"a": 1}, {"a": 2}]).count() == 2
    assert rd.from_items([5, 6, 7]).take_all() == [{"item": 5}, {"item": 6}, {"item": 7}]


def test_file_roundtrips(ray_start_regular, tmp_path):
    ds = rd.range(50, parallelism=3).map(lambda r: {"id": r["id"], "txt": f"row{r['id']}"})
    pq_dir = str(tmp_path / "pq")
    ds.write_parquet(pq_dir)
    back = rd.read_parquet(pq_dir)
    assert back.count() == 50
    assert sorted(r["id"] for r in back.take_all()) == list(range(50))

    csv_dir = str(tmp_path / "csv")
    ds.write_csv(csv_dir)
    assert rd.read_csv(csv_dir).count() == 50

    js_dir = str(tmp_path / "js")
    ds.write_json(js_dir)
    assert rd.read_json(js_dir).count() == 50
    assert sorted(r["txt"] for r in rd.read_json(js_dir).take_all()) == sorted(f"row{i}" for i in range(50))


def test_read_text_binary(ray_start_regular, tmp_path):
    p = tmp_path / "f.txt"
    p.write_text("alpha\nbeta\n\ngamma\n")
    assert rd.read_text(str(p)).take_all() == [{"text": "alpha"}, {"text": "beta"}, {"text": "gamma"}]
    bp = tmp_path / "f.bin"
    bp.write_bytes(b"\x00\x01\x02")
    rows = rd.read_binary_files(str(bp), include_paths=True).take_all()
    assert rows[0]["bytes"] == b"\x00\x01\x02"


def test_iter_batches_shapes(ray_start_regular):
    ds = rd.range(100, parallelism=4)
    assert [len(b["id"]) for b in ds.iter_batches(batch_size=32)] == [32, 32, 32, 4]
    assert [len(b["id"]) for b in ds.iter_batches(batch_size=32, drop_last=True)] == [32, 32, 32]
    ids = [
        int(x)
        for b in ds.iter_batches(batch_size=10, local_shuffle_buffer_size=50, local_shuffle_seed=0)
        for x in b["id"]
    ]
    assert sorted(ids) == list(range(100)) and ids != list(range(100))


def test_iter_torch_batches(ray_start_regular):
    """The counterpart of the reference's ``test_iter_jax_batches``."""
    ds = rd.range(32, parallelism=2)
    batches = list(ds.iter_torch_batches(batch_size=16, dtypes={"id": torch.float32}, device="cpu"))
    assert len(batches) == 2
    assert isinstance(batches[0]["id"], torch.Tensor)
    assert batches[0]["id"].dtype == torch.float32 and batches[0]["id"].device.type == "cpu"


def test_split_and_train_test_split(ray_start_regular):
    ds = rd.range(100, parallelism=10)
    assert sum(s.count() for s in ds.split(4)) == 100
    assert all(s.count() == 25 for s in ds.split(4, equal=True))
    train, test = ds.train_test_split(0.2)
    assert train.count() == 80 and test.count() == 20


def _consume_split(its, epochs: int, batch_size: int):
    out = []
    for _ in range(epochs):
        results = [[] for _ in its]

        def consume(i):
            for b in its[i].iter_batches(batch_size=batch_size, prefetch_batches=0):
                results[i].extend(int(x) for x in b["id"])

        ts = [threading.Thread(target=consume, args=(i,)) for i in range(len(its))]
        [t.start() for t in ts]
        [t.join(timeout=60) for t in ts]
        out.append(results)
    return out


def test_streaming_split_multi_epoch(ray_start_regular):
    its = rd.range(80, parallelism=8).streaming_split(2, equal=False)
    for results in _consume_split(its, 2, 10):
        assert sorted(results[0] + results[1]) == list(range(80))


def test_materialize_reuse(ray_start_regular):
    calls = []

    def trace(b):
        calls.append(1)
        return b

    ds = rd.range(20, parallelism=2).map_batches(trace).materialize()
    n_after_materialize = len(calls)
    assert ds.count() == 20 and ds.count() == 20
    assert len(calls) == n_after_materialize


def test_unique_and_random_sample(ray_start_regular):
    ds = rd.range(100).map(lambda r: {"k": r["id"] % 5})
    assert ds.unique("k") == [0, 1, 2, 3, 4]
    frac = rd.range(1000, parallelism=4).random_sample(0.1, seed=0).count()
    assert 40 < frac < 250


def test_schema_and_stats(ray_start_regular):
    ds = rd.range(10)
    assert ds.columns() == ["id"]
    assert ds.size_bytes() > 0
    assert "rows=10" in ds.stats()


def test_sort_empty_after_filter(ray_start_regular):
    ds = rd.range(10, parallelism=2).filter(lambda r: r["id"] > 100).sort("id")
    assert ds.take_all() == []


def test_groupby_string_keys(ray_start_regular):
    ds = rd.range(40, parallelism=4).map(lambda r: {"k": f"key{r['id'] % 4}", "v": 1})
    rows = ds.groupby("k").count().take_all()
    assert {r["k"]: r["count()"] for r in rows} == {f"key{i}": 10 for i in range(4)}


def test_early_break_iter_batches(ray_start_regular):
    ds = rd.range(1000, parallelism=8)
    for i, _ in enumerate(ds.iter_batches(batch_size=10, prefetch_batches=2)):
        if i == 2:
            break
    assert ds.count() == 1000


def _varint(x):
    out = b""
    while True:
        b7 = x & 0x7F
        x >>= 7
        if x:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _ld(tag, data):
    return _varint((tag << 3) | 2) + _varint(len(data)) + data


def write_tfrecord(path, examples):
    """tf.train.Example records: ``{key: int list | bytes}`` each."""

    def feature(v):
        if isinstance(v, bytes):
            return _ld(1, _ld(1, v))
        body = b"".join(_varint(1 << 3) + _varint(x & ((1 << 64) - 1)) for x in v)
        return _ld(3, body)

    with open(path, "wb") as f:
        for ex in examples:
            rec = _ld(1, b"".join(_ld(1, _ld(1, k.encode()) + _ld(2, feature(v))) for k, v in ex.items()))
            f.write(struct.pack("<Q", len(rec)) + b"\x00" * 4 + rec + b"\x00" * 4)


def test_tfrecords_roundtrip_signed(ray_start_regular, tmp_path):
    path = tmp_path / "data.tfrecord"
    write_tfrecord(path, [{"label": [-1], "name": b"abc"}])
    rows = rd.read_tfrecords(str(path)).take_all()
    assert rows[0]["label"] == -1
    assert rows[0]["name"] == b"abc"


def test_zip_tensor_shapes_and_collisions(ray_start_regular):
    a = rd.from_numpy(np.arange(24, dtype=np.float32).reshape(6, 2, 2), column="data")
    b = rd.from_numpy(np.arange(18, dtype=np.float32).reshape(6, 3), column="data")
    batch = a.zip(b).take_batch(6)
    assert batch["data"].shape == (6, 2, 2)
    assert batch["data_1"].shape == (6, 3)


def test_streaming_split_equal_splits_remainder_rows(ray_start_regular):
    its = rd.range(50, parallelism=5).streaming_split(2, equal=True)
    (results,) = _consume_split(its, 1, 100)
    assert len(results[0]) == len(results[1]) == 25
    assert sorted(results[0] + results[1]) == list(range(50))


def test_read_sql_sqlite(ray_start_regular, tmp_path):
    import sqlite3

    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE users (id INTEGER, score REAL)")
    conn.executemany("INSERT INTO users VALUES (?, ?)", [(i, i * 0.5) for i in range(50)])
    conn.commit()
    conn.close()

    ds = rd.read_sql("SELECT id, score FROM users", lambda: sqlite3.connect(db))
    assert ds.count() == 50
    rows = ds.take(5)
    assert rows[0]["id"] == 0 and rows[4]["score"] == 2.0
    ds4 = rd.read_sql("SELECT id, score FROM users", lambda: sqlite3.connect(db),
                      parallelism=4, order_by="id")
    assert sorted(r["id"] for r in ds4.take_all()) == list(range(50))


# -- the data test of tests/test_streaming_generators.py ---------------------


def test_data_pipeline_starts_before_read_finishes(ray_start_regular):
    import time

    from ray_tpu_torch.data.datasource import BlockMetadata, Datasource, ReadTask

    def slow_blocks():
        yield {"x": np.arange(10)}
        time.sleep(6.0)  # tail of the read: must NOT gate the first batch
        yield {"x": np.arange(10, 20)}

    class SlowSource(Datasource):
        def get_read_tasks(self, parallelism):
            meta = BlockMetadata(num_rows=None, size_bytes=None, input_files=None)
            return [ReadTask(slow_blocks, meta)]

    ds = rd.read_datasource(SlowSource()).map(lambda row: {"x": row["x"] + 1})
    t0 = time.monotonic()
    first = next(iter(ds.iter_batches(batch_size=10)))
    assert time.monotonic() - t0 < 5.0, "first batch waited for the whole read"
    assert list(first["x"])[:3] == [1, 2, 3]


# -- the numpy-dict block ----------------------------------------------------


def test_block_strings_of_any_width_concatenate():
    a = BlockAccessor.batch_to_block({"s": np.array(["a", "bb"])})
    b = BlockAccessor.batch_to_block({"s": np.array(["cccc"])})
    assert a["s"].dtype == object and b["s"].dtype == object
    out = BlockAccessor.concat([a, b])
    assert out["s"].tolist() == ["a", "bb", "cccc"]
    raw = BlockAccessor.rows_to_block([{"b": b"x\x00"}, {"b": b"\x00"}])
    assert raw["b"].tolist() == [b"x\x00", b"\x00"]  # no trailing NUL dropped


def test_block_object_and_typed_column_concatenate_as_object():
    typed = BlockAccessor.rows_to_block([{"t": [1, 2]}, {"t": [3, 4]}])
    ragged = BlockAccessor.rows_to_block([{"t": [5]}, {"t": [6, 7, 8]}])
    assert typed["t"].shape == (2, 2) and ragged["t"].dtype == object
    out = BlockAccessor.concat([typed, ragged])
    assert out["t"].dtype == object and len(out["t"]) == 4
    assert [list(x) for x in out["t"]] == [[1, 2], [3, 4], [5], [6, 7, 8]]


def test_block_concat_refuses_a_schema_mismatch_and_keeps_empty_columns():
    ints = {"x": np.arange(3)}
    with pytest.raises(ValueError, match="int64"):
        BlockAccessor.concat([ints, {"x": np.arange(2, dtype=np.int32)}])
    with pytest.raises(ValueError, match="different columns"):
        BlockAccessor.concat([ints, {"y": np.arange(2)}])
    with pytest.raises(ValueError, match="column 'x'"):
        BlockAccessor.concat([{"x": np.zeros((2, 3))}, {"x": np.zeros((2, 4))}])
    empty = {"x": np.zeros(0, dtype=np.int64)}
    assert BlockAccessor.concat([empty, empty]) is empty
    assert BlockAccessor.concat([empty, ints]) is ints
    assert BlockAccessor.concat([]) == {}


def test_block_views_sizes_and_conversions():
    block = {"x": np.arange(12).reshape(6, 2), "s": np.array(["ab", "cde", "", "f", "g", "h"], dtype=object)}
    acc = BlockAccessor(block)
    batch = acc.to_numpy_batch()
    assert np.shares_memory(batch["x"], block["x"]) and not batch["x"].flags.writeable
    sl = acc.slice(2, 4)
    assert np.shares_memory(sl["x"], block["x"]) and sl["s"].tolist() == ["", "f"]
    assert acc.take_indices(np.array([5, 0]))["x"].tolist() == [[10, 11], [0, 1]]
    assert acc.size_bytes() == block["x"].nbytes + block["s"].nbytes + len("abcdefgh")
    t = acc.to_arrow()
    back = BlockAccessor.batch_to_block(t)
    assert back["x"].shape == (6, 2) and back["s"].tolist() == block["s"].tolist()
    df = acc.to_pandas()
    assert list(df.columns) == ["x", "s"] and len(df) == 6
    assert BlockAccessor(df).block["s"].tolist() == block["s"].tolist()


def test_iter_torch_batches_copies_views_of_the_store(ray_start_regular):
    """A batch that is a slice of one stored block is a view of shared
    memory: on the CPU the tensor handed out is a copy, so an in-place op
    leaves the dataset as it was."""
    ds = rd.from_numpy(np.arange(4096, dtype=np.int64).reshape(1024, 4), column="x").materialize()
    for _ in range(2):
        for b in ds.iter_torch_batches(batch_size=256, device="cpu"):
            assert b["x"].is_contiguous()
            b["x"].mul_(0)
        np.testing.assert_array_equal(ds.take_batch(1024)["x"], np.arange(4096).reshape(1024, 4))


def test_iter_torch_batches_equal_iter_batches(ray_start_regular):
    ds = rd.range(100, parallelism=3).map_batches(
        lambda b: {"id": b["id"], "x": np.stack([b["id"], -b["id"]], 1).astype(np.int32)})
    kw = dict(batch_size=16, local_shuffle_buffer_size=32, local_shuffle_seed=3)
    want = list(ds.iter_batches(**kw))
    got = list(ds.iter_torch_batches(dtypes={"x": torch.float64}, device="cpu", **kw))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g["id"].dtype == torch.int64 and g["x"].dtype == torch.float64
        np.testing.assert_array_equal(g["id"].numpy(), w["id"])
        np.testing.assert_array_equal(g["x"].numpy(), w["x"].astype(np.float64))
    with pytest.raises(TypeError, match="NamedSharding"):
        ds.iter_torch_batches(sharding=object(), device="cpu")


def test_map_gpus_need_a_gpu(ray_start_regular):
    """A map that asks for a card carries ``num_gpus`` to its tasks: on a
    cluster without one the task is refused at once."""
    with pytest.raises(Exception, match="GPU"):
        rd.range(4).map_batches(lambda b: b, num_gpus=1).take_all()


# -- TorchTrainer fed a Dataset ----------------------------------------------


SHAPE = dict(vocab_size=128, seq_len=32, d_model=64, n_layers=2, n_heads=2, dtype="float32")
BATCH, STEPS = 4, 5


def _token_files(tmp_path, files: int = 3, rows: int = 7):
    """``files`` .npy shards of ``rows`` token rows each; batches of
    ``BATCH`` then straddle files."""
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, SHAPE["vocab_size"], (files * rows, SHAPE["seq_len"] + 1))
    d = tmp_path / "tokens"
    d.mkdir()
    for i in range(files):
        np.save(d / f"shard-{i:03d}.npy", tokens[i * rows:(i + 1) * rows])
    return str(d), tokens


def _fit(loop, datasets, workers: int, tmp_path, name: str, **config):
    from ray_tpu_torch import train

    result = train.TorchTrainer(
        loop,
        train_loop_config=dict(shape=SHAPE, **config),
        scaling_config=train.ScalingConfig(num_workers=workers),
        run_config=train.RunConfig(name=name, storage_path=str(tmp_path / "runs"), verbose=0),
        datasets=datasets,
    ).fit()
    assert result.error is None, result.error
    return [h["metrics"] for h in result.metrics_history]


def test_trainer_over_a_dataset_equals_the_plain_list(ray_start_regular, tmp_path):
    """One worker trains the narrow fp32 GPT from a ``read_numpy`` Dataset
    through ``iter_torch_batches``, and from the same batches as a plain
    list: the losses are equal bit for bit."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import adamw, build_train_step

    def loop(config):
        import numpy as np
        import torch

        from ray_tpu_torch import train

        torch.set_num_threads(2)
        cfg = gpt.GPTConfig(**config["shape"])
        init_fn, step_fn = build_train_step(lambda p, t: gpt.gpt_loss(cfg, p, t), adamw(1e-3))
        state = init_fn(gpt.gpt_init(cfg, torch.Generator().manual_seed(0), "cpu"), "cpu")
        shard = train.get_dataset_shard("train")
        if hasattr(shard, "iter_torch_batches"):
            batches = (b["tokens"] for b in shard.iter_torch_batches(batch_size=4, drop_last=True,
                                                                     device="cpu"))
        else:
            batches = (torch.from_numpy(np.asarray(b)) for b in shard)
        for i, tokens in enumerate(batches):
            state, loss = step_fn(state, tokens)
            train.report({"step": i, "loss": loss.item(), "rows": tokens.shape[0]})

    path, tokens = _token_files(tmp_path)
    ds = rd.read_numpy(path, column="tokens")
    from_ds = _fit(loop, {"train": ds}, 1, tmp_path, "dataset")
    plain = [tokens[i * BATCH:(i + 1) * BATCH] for i in range(STEPS)]
    from_list = _fit(loop, {"train": plain}, 1, tmp_path, "list")
    assert [m["step"] for m in from_ds] == list(range(STEPS))
    assert all(m["rows"] == BATCH for m in from_ds)
    assert [m["loss"] for m in from_ds] == [m["loss"] for m in from_list]
    assert all(np.isfinite(m["loss"]) for m in from_ds)


def test_trainer_two_workers_get_disjoint_shares(ray_start_regular, tmp_path):
    """Two CPU workers each get their ``split(2)`` share of a Dataset: the
    shares are disjoint and together cover every row."""

    def loop(config):
        import json
        import os

        from ray_tpu_torch import train

        shard = train.get_dataset_shard("train")
        ids = [int(x) for b in shard.iter_torch_batches(batch_size=5, device="cpu") for x in b["id"]]
        rank = train.get_context().get_world_rank()
        with open(os.path.join(config["out"], f"rank{rank}.json"), "w") as f:
            json.dump(ids, f)
        train.report({"rank": rank})

    import json

    ds = rd.range(60, parallelism=6).random_shuffle(seed=None)
    _fit(loop, {"train": ds}, 2, tmp_path, "two", out=str(tmp_path))
    shares = {r: json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)}
    assert sorted(shares) == [0, 1]
    assert shares[0] and shares[1] and not set(shares[0]) & set(shares[1])
    assert sorted(shares[0] + shares[1]) == list(range(60))


# -- the data test of tests/test_chaos.py (last: it kills workers) -----------


def test_data_pipeline_under_kills(ray_start_regular):
    from ray_tpu_torch._private.chaos import ResourceKiller

    with ResourceKiller(interval_s=0.5, seed=8, max_kills=4) as killer:
        ds = rd.range(400, parallelism=16).map(lambda r: {"v": r["id"] * 3})
        total = sum(r["v"] for r in ds.take_all())
    assert total == 3 * sum(range(400))
    assert killer.kills
