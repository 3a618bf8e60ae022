"""The port's datasources: a mirror of ``tests/test_data_sources_ext.py`` on
``ray_tpu_torch.data`` (WebDataset shards, gated Mongo/BigQuery, the
``ray://`` client, Avro, ORC, feather, WAV, XML, Delta, ClickHouse,
Databricks, Snowflake, the gated long tail), the numpy, image and
JSON-lines paths, and the port on a host without pyarrow and pandas (the
card's machine has neither): there the numpy, text, binary, TFRecords, Avro
and JSON-lines paths, the exchanges, splits and ``iter_torch_batches`` work
and the pyarrow formats raise ``ImportError`` naming pyarrow."""

import io
import json
import os
import subprocess
import sys
import tarfile
import textwrap
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rdata

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def _shared_cluster():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_regular(_shared_cluster):
    yield


def _make_shard(path, n=4):
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            for ext, payload in (
                ("txt", f"caption {i}".encode()),
                ("cls", str(i % 2).encode()),
                ("json", json.dumps({"idx": i}).encode()),
            ):
                info = tarfile.TarInfo(name=f"sample{i:04d}.{ext}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))


class TestWebDataset:
    def test_read_samples(self, ray_start_regular, tmp_path):
        shard = str(tmp_path / "data-0000.tar")
        _make_shard(shard, n=4)
        rows = rdata.read_webdataset(shard).take_all()
        assert len(rows) == 4
        assert rows[0]["txt"] == "caption 0"
        assert rows[0]["cls"] in (0, 1)
        assert rows[1]["json"]["idx"] == 1
        assert rows[2]["__key__"] == "sample0002"

    def test_multiple_shards_parallel(self, ray_start_regular, tmp_path):
        for i in range(3):
            _make_shard(str(tmp_path / f"data-{i:04d}.tar"), n=2)
        assert rdata.read_webdataset(str(tmp_path / "data-*.tar"), parallelism=3).count() == 6

    def test_no_decode(self, ray_start_regular, tmp_path):
        shard = str(tmp_path / "raw.tar")
        _make_shard(shard, n=1)
        assert rdata.read_webdataset(shard, decode=False).take_all()[0]["txt"] == b"caption 0"


class TestGatedSources:
    def test_mongo_requires_pymongo(self):
        try:
            import pymongo  # noqa: F401

            pytest.skip("pymongo installed; gating not exercised")
        except ImportError:
            pass
        with pytest.raises(ImportError, match="pymongo"):
            rdata.read_mongo("mongodb://x", "db", "coll")

    def test_bigquery_requires_client(self):
        try:
            from google.cloud import bigquery  # noqa: F401

            pytest.skip("bigquery installed; gating not exercised")
        except ImportError:
            pass
        with pytest.raises(ImportError, match="bigquery"):
            rdata.read_bigquery("proj", query="select 1")


class TestRayClientScheme:
    def test_ray_scheme_attaches_over_tcp(self):
        """``ray://host:port`` attaches to a head in another process, and a
        Dataset executes through it."""
        key = os.urandom(16).hex()
        env = dict(os.environ, RAY_TPU_AUTHKEY=key, PYTHONPATH=str(REPO))
        script = (
            "import ray_tpu_torch, time;"
            "ray_tpu_torch.init(num_cpus=2, num_gpus=0);"
            "from ray_tpu_torch._private.runtime import get_ctx;"
            "h, p = get_ctx().head.listen_tcp('127.0.0.1', 0);"
            "print(f'ADDR {h}:{p}', flush=True);"
            "time.sleep(60)"
        )
        proc = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE, text=True, env=env)
        code = textwrap.dedent("""
            import sys, ray_tpu_torch
            from ray_tpu_torch import data as rd
            ray_tpu_torch.init(address="ray://" + sys.argv[1])

            @ray_tpu_torch.remote
            def f(x):
                return x * 7

            assert ray_tpu_torch.get(f.remote(6), timeout=60) == 42
            assert rd.range(20, parallelism=2).map(lambda r: {"v": r["id"] * 2}).sum("v") == 380
            ray_tpu_torch.shutdown()
            print("CLIENT OK")
        """)
        try:
            line = proc.stdout.readline()
            assert line.startswith("ADDR"), line
            out = subprocess.run([sys.executable, "-c", code, line.split()[1]], env=env, cwd=REPO,
                                 capture_output=True, text=True, timeout=120)
            assert "CLIENT OK" in out.stdout, out.stdout[-2000:] + out.stderr[-4000:]
        finally:
            proc.terminate()
            proc.wait(timeout=10)


def _zigzag(n: int) -> bytes:
    """Independent avro varint encoder (written from the spec)."""
    u = (n << 1) ^ (n >> 63) if n < 0 else n << 1
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def avro_file(rows, deflate=False) -> bytes:
    """Minimal OCF writer for {"a": long, "b": string} records."""
    import zlib

    schema = {"type": "record", "name": "R",
              "fields": [{"name": "a", "type": "long"}, {"name": "b", "type": "string"}]}
    sj = json.dumps(schema).encode()
    codec = b"deflate" if deflate else b"null"
    sync = b"S" * 16
    head = b"Obj\x01" + _zigzag(2)
    head += _zigzag(len(b"avro.schema")) + b"avro.schema" + _zigzag(len(sj)) + sj
    head += _zigzag(len(b"avro.codec")) + b"avro.codec" + _zigzag(len(codec)) + codec
    head += _zigzag(0) + sync
    payload = b""
    for r in rows:
        b = r["b"].encode()
        payload += _zigzag(r["a"]) + _zigzag(len(b)) + b
    if deflate:
        comp = zlib.compressobj(wbits=-15)
        payload = comp.compress(payload) + comp.flush()
    return head + _zigzag(len(rows)) + _zigzag(len(payload)) + payload + sync


@pytest.mark.parametrize("deflate", [False, True])
def test_read_avro_roundtrip(ray_start_regular, tmp_path, deflate):
    rows = [{"a": i * 7 - 3, "b": f"row-{i}"} for i in range(20)]
    p = tmp_path / "data.avro"
    p.write_bytes(avro_file(rows, deflate=deflate))
    assert rdata.read_avro(str(p)).take_all() == rows


def test_read_orc_roundtrip(ray_start_regular, tmp_path):
    import pyarrow as pa
    from pyarrow import orc

    p = tmp_path / "data.orc"
    orc.write_table(pa.table({"x": list(range(10)), "y": [f"s{i}" for i in range(10)]}), str(p))
    out = rdata.read_orc(str(p)).take_all()
    assert [r["x"] for r in out] == list(range(10))
    assert set(rdata.read_orc(str(p), columns=["y"]).take_all()[0]) == {"y"}


def test_read_feather_roundtrip(ray_start_regular, tmp_path):
    import pyarrow as pa
    import pyarrow.feather as feather

    p = tmp_path / "data.feather"
    feather.write_feather(pa.table({"v": [1.5, 2.5, 3.5]}), str(p))
    assert [r["v"] for r in rdata.read_feather(str(p)).take_all()] == [1.5, 2.5, 3.5]


def write_wav(path, samples, rate=8000):
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(samples.tobytes())


def test_read_audio_wav(ray_start_regular, tmp_path):
    p = tmp_path / "tone.wav"
    samples = (np.sin(np.linspace(0, 440, 8000)) * 32767).astype(np.int16)
    write_wav(p, samples)
    out = rdata.read_audio(str(p)).take_all()
    assert out[0]["sample_rate"] == 8000
    assert out[0]["amplitude"].shape == (8000, 1)
    assert out[0]["amplitude"][:100, 0].tolist() == samples[:100].tolist()


def test_read_xml(ray_start_regular, tmp_path):
    p = tmp_path / "rows.xml"
    p.write_text("<rows><item id='1'><name>ann</name><age>30</age></item>"
                 "<item id='2'><name>bo</name><age>40</age></item></rows>")
    assert rdata.read_xml(str(p), record_tag="item").take_all() == [
        {"id": "1", "name": "ann", "age": "30"},
        {"id": "2", "name": "bo", "age": "40"},
    ]


def test_read_delta_log_replay(ray_start_regular, tmp_path):
    import pyarrow as pa
    from pyarrow import parquet as pq

    for i in range(3):
        pq.write_table(pa.table({"v": [i * 10, i * 10 + 1]}), str(tmp_path / f"part-{i}.parquet"))
    log = tmp_path / "_delta_log"
    log.mkdir()
    (log / "00000000000000000000.json").write_text(
        json.dumps({"add": {"path": "part-0.parquet"}}) + "\n"
        + json.dumps({"add": {"path": "part-1.parquet"}}) + "\n")
    (log / "00000000000000000001.json").write_text(
        json.dumps({"remove": {"path": "part-0.parquet"}}) + "\n"
        + json.dumps({"add": {"path": "part-2.parquet"}}) + "\n")
    assert sorted(r["v"] for r in rdata.read_delta(str(tmp_path)).take_all()) == [10, 11, 20, 21]


def test_read_clickhouse_fake_transport(ray_start_regular):
    def transport(url, body):
        q = body.decode()
        assert "FORMAT JSONEachRow" in q and q.count("FORMAT") == 1, q
        assert url == "http://ch:8123"
        return b'{"a": 1, "b": "x"}\n{"a": 2, "b": "y"}\n'

    out = rdata.read_clickhouse("http://ch:8123", "SELECT a, b FROM t;", transport=transport).take_all()
    assert out == [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}]


def test_read_databricks_fake_transport(ray_start_regular):
    def transport(url, body, headers):
        assert headers["Authorization"] == "Bearer tok"
        assert "/api/2.0/sql/statements" in url
        return json.dumps({
            "status": {"state": "SUCCEEDED"},
            "manifest": {"schema": {"columns": [{"name": "id"}, {"name": "v"}]}},
            "result": {"data_array": [[1, "a"], [2, "b"]]},
        }).encode()

    out = rdata.read_databricks_tables(host="https://dbx", token="tok", warehouse_id="w1",
                                       query="SELECT * FROM t", transport=transport).take_all()
    assert out == [{"id": 1, "v": "a"}, {"id": 2, "v": "b"}]


def test_read_snowflake_dbapi_factory(ray_start_regular, tmp_path):
    import sqlite3

    db = str(tmp_path / "sf.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (id INTEGER, name TEXT)")
    conn.executemany("INSERT INTO t VALUES (?, ?)", [(i, f"n{i}") for i in range(6)])
    conn.commit()
    conn.close()
    out = rdata.read_snowflake("SELECT id, name FROM t", connection_factory=lambda: sqlite3.connect(db)).take_all()
    assert sorted(r["id"] for r in out) == list(range(6))


def test_gated_sources_error_clearly(ray_start_regular):
    for fn, args, kwargs in [
        (rdata.read_lance, ("/nope",), {}),
        (rdata.read_iceberg, ("db.t",), {}),
        (rdata.read_hudi, ("/nope",), {}),
        (rdata.read_snowflake, ("q",), {"connection_parameters": {"user": "u"}}),
    ]:
        with pytest.raises(ImportError) as e:
            fn(*args, **kwargs)
        assert "not installed" in str(e.value)


def test_read_parquet_bulk_alias(ray_start_regular, tmp_path):
    import pyarrow as pa
    from pyarrow import parquet as pq

    for i in range(4):
        pq.write_table(pa.table({"v": [i]}), str(tmp_path / f"f{i}.parquet"))
    assert sorted(r["v"] for r in rdata.read_parquet_bulk(str(tmp_path)).take_all()) == [0, 1, 2, 3]


# -- the port's own paths ------------------------------------------------------


def test_read_numpy_keeps_file_order_and_shapes(ray_start_regular, tmp_path):
    arrs = [np.arange(i * 30, (i + 1) * 30, dtype=np.int32).reshape(10, 3) for i in range(5)]
    for i, a in enumerate(arrs):
        np.save(tmp_path / f"part-{i:02d}.npy", a)
    ds = rdata.read_numpy(str(tmp_path), column="tokens", parallelism=2)
    batch = ds.take_batch(50)
    np.testing.assert_array_equal(batch["tokens"], np.concatenate(arrs))
    assert batch["tokens"].dtype == np.int32
    out = tmp_path / "out"
    ds.write_numpy(str(out), column="tokens")
    np.testing.assert_array_equal(rdata.read_numpy(str(out), column="t").take_batch(50)["t"],
                                  np.concatenate(arrs))


def test_read_images(ray_start_regular, tmp_path):
    from PIL import Image

    imgs = [np.full((4, 6, 3), i * 40, dtype=np.uint8) for i in range(3)]
    for i, a in enumerate(imgs):
        Image.fromarray(a).save(tmp_path / f"img{i}.png")
    batch = rdata.read_images(str(tmp_path), include_paths=True).take_batch(3)
    np.testing.assert_array_equal(batch["image"], np.stack(imgs))
    assert [os.path.basename(p) for p in batch["path"]] == ["img0.png", "img1.png", "img2.png"]
    assert rdata.read_images(str(tmp_path), size=(2, 3)).take_batch(3)["image"].shape == (3, 2, 3, 3)


def test_json_lines_nested_and_whole_documents(ray_start_regular, tmp_path):
    ds = rdata.from_items([{"k": i, "s": f"s{i}", "v": [i, -i]} for i in range(6)])
    ds.write_json(str(tmp_path / "j"))
    rows = sorted(rdata.read_json(str(tmp_path / "j")).take_all(), key=lambda r: r["k"])
    assert [(r["k"], r["s"], list(r["v"])) for r in rows] == [(i, f"s{i}", [i, -i]) for i in range(6)]
    doc = tmp_path / "doc.json"
    doc.write_text(json.dumps([{"a": 1}, {"a": 2}], indent=2))
    assert rdata.read_json(str(doc)).take_all() == [{"a": 1}, {"a": 2}]


# -- without pyarrow and pandas ------------------------------------------------

_BLOCKER = '''
import sys


class _Refuse:
    """A meta-path finder that refuses pyarrow and pandas, as on the card's
    machine, where neither is installed."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("pyarrow", "pandas"):
            raise ImportError(f"No module named {name!r} (refused)")
        return None


sys.meta_path.insert(0, _Refuse())
'''

_WITHOUT_ARROW = r'''
import json, os, sqlite3, struct, sys, zlib

import numpy as np

import ray_tpu_torch
from ray_tpu_torch import data as rd

tmp, avro_path, tfr_path = sys.argv[1], sys.argv[2], sys.argv[3]
ray_tpu_torch.init(num_cpus=2, num_gpus=0)
out = {}

@ray_tpu_torch.remote
def worker_imports():
    try:
        import pyarrow  # noqa: F401
        return "pyarrow imported"
    except ImportError as e:
        return str(e)

out["worker"] = ray_tpu_torch.get(worker_imports.remote())
for i in range(3):
    np.save(os.path.join(tmp, f"n{i}.npy"), np.arange(i * 20, (i + 1) * 20).reshape(10, 2))
with open(os.path.join(tmp, "t.txt"), "w") as f:
    f.write("a\nbb\n\nccc\n")
with open(os.path.join(tmp, "b.bin"), "wb") as f:
    f.write(b"\x00\x01")
nums = rd.read_numpy(os.path.join(tmp, "n*.npy"), column="x")
out["numpy"] = nums.take_batch(30)["x"].sum().item()
out["text"] = [r["text"] for r in rd.read_text(os.path.join(tmp, "t.txt")).take_all()]
out["binary"] = rd.read_binary_files(os.path.join(tmp, "b.bin")).take_all()[0]["bytes"].hex()
out["tfrecords"] = rd.read_tfrecords(tfr_path).take_all()[0]["label"]
out["avro"] = rd.read_avro(avro_path).take_all()[1]
ds = rd.range(40, parallelism=4).map(lambda r: {"k": f"k{r['id'] % 3}", "v": float(r["id"])})
ds.write_json(os.path.join(tmp, "js"))
out["json"] = sorted(r["v"] for r in rd.read_json(os.path.join(tmp, "js")).take_all()) == [float(i) for i in range(40)]
out["shuffle"] = [r["v"] for r in ds.random_shuffle(seed=1).take(5)]
out["sort"] = [r["k"] for r in ds.sort("k", descending=True).take(3)]
out["groupby"] = sorted((r["k"], r["sum(v)"]) for r in ds.groupby("k").sum("v").take_all())
out["zip"] = rd.range(4).zip(rd.range(4).map(lambda r: {"id": -r["id"]})).take_batch(4)["id_1"].tolist()
out["split"] = [s.count() for s in ds.split(3, equal=True)]
import torch
batches = list(nums.iter_torch_batches(batch_size=8, device="cpu", dtypes={"x": torch.float32}))
out["torch"] = [tuple(b["x"].shape) for b in batches]
for name, call in (("read_parquet", lambda: rd.read_parquet(tmp).take_all()),
                   ("write_parquet", lambda: ds.write_parquet(os.path.join(tmp, "pq"))),
                   ("read_csv", lambda: rd.read_csv(os.path.join(tmp, "t.txt")).take_all())):
    try:
        call()
        out[name] = "no error"
    except Exception as e:  # the error crosses the task boundary wrapped
        out[name] = f"{type(e).__name__}: {e}"
out["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in ("pyarrow", "pandas"))
ray_tpu_torch.shutdown()
print("RESULT " + json.dumps(out))
'''


def test_the_port_without_pyarrow_and_pandas(tmp_path):
    from test_torch_data import write_tfrecord

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCKER)
    work = tmp_path / "work"
    work.mkdir()
    avro = tmp_path / "a.avro"
    avro.write_bytes(avro_file([{"a": 1, "b": "x"}, {"a": -2, "b": "yy"}], deflate=True))
    tfr = tmp_path / "d.tfrecord"
    write_tfrecord(tfr, [{"label": [-5], "name": b"n"}])
    # the blocker rides PYTHONPATH, so the runtime's workers refuse too
    env = {**os.environ, "PYTHONPATH": f"{site}{os.pathsep}{REPO}"}
    proc = subprocess.run([sys.executable, "-c", _WITHOUT_ARROW, str(work), str(avro), str(tfr)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    out = json.loads(next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))[7:])
    assert "refused" in out["worker"]
    assert out["numpy"] == sum(range(60))
    assert out["text"] == ["a", "bb", "ccc"]
    assert out["binary"] == "0001"
    assert out["tfrecords"] == -5
    assert out["avro"] == {"a": -2, "b": "yy"}
    assert out["json"] is True
    assert len(out["shuffle"]) == 5 and out["shuffle"] != [0.0, 1.0, 2.0, 3.0, 4.0]
    assert out["sort"] == ["k2"] * 3
    assert out["groupby"] == [[f"k{k}", float(sum(range(k, 40, 3)))] for k in range(3)]
    assert out["zip"] == [0, -1, -2, -3]
    assert out["split"] == [13, 13, 13]
    assert out["torch"] == [[8, 2]] * 3 + [[6, 2]]
    for name in ("read_parquet", "write_parquet", "read_csv"):
        assert "ImportError" in out[name] and "needs pyarrow" in out[name], out[name]
    assert out["loaded"] == []
