"""One set of Data workloads through both packages: ``ray_tpu.data`` and
``ray_tpu_torch.data``, each in a fresh process of its own with its own
runtime, on the same inputs (files written here from numpy seeds).

The cases: range -> map -> filter -> map_batches; ``random_shuffle(seed)``
(the row order itself); sort (a number descending, a string, two keys);
groupby on an int and a string key with every aggregate, and the global
aggregates; union and zip; ``split`` (plain and equal) and
``train_test_split`` (plain and shuffled); ``streaming_split(2,
equal=True)``'s rows per consumer; every reader on the same files (numpy,
text, binary, TFRecords, Avro, JSON lines, CSV, parquet, WebDataset, XML,
WAV, SQL, ORC, feather, images); each writer's output read back.

Tolerance: equal, exactly, for ints, strings and bytes and for every row
order. Float aggregates (sum, mean, std of a float column) within rtol
1e-12: both packages run the same numpy on the same blocks, so only a
different summation order could move them (none was seen). No order
differs: both keep dataset order through maps, read files in sorted path
order, seed the shuffle alike, and emit groups sorted within each
hash partition.
"""

import json
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-12

WORKLOAD = r'''
import importlib, os, pickle, sqlite3, sys, threading

import numpy as np

pkg, inputs, out_path = sys.argv[1], sys.argv[2], sys.argv[3]
rt = importlib.import_module(pkg)
rd = importlib.import_module(pkg + ".data")
agg = importlib.import_module(pkg + ".data.aggregate")
if pkg == "ray_tpu":
    rt.init(num_cpus=4, num_tpus=0)
else:
    rt.init(num_cpus=4, num_gpus=0)


def plain(x):
    """Rows as plain Python values (arrays as lists)."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def rows(ds):
    return plain(ds.take_all())


def ids(ds, col="id"):
    return [r[col] for r in rows(ds)]


P = lambda *a: os.path.join(inputs, *a)
out = {}
base = rd.range(200, parallelism=5).map(
    lambda r: {"id": r["id"], "sq": r["id"] ** 2 % 97, "s": "r%d" % (r["id"] % 11)})
out["pipeline"] = rows(base.filter(lambda r: r["sq"] > 10).map_batches(
    lambda b: {"id": b["id"], "s": b["s"], "x": b["id"] * 0.5 + b["sq"]}))

tokens = rd.read_numpy(P("numpy"), column="tokens")
out["shuffle_range"] = ids(rd.range(1000, parallelism=8).random_shuffle(seed=7))
out["shuffle_tokens"] = [r["tokens"] for r in rows(tokens.random_shuffle(seed=3))]
out["shuffle_map"] = rows(base.random_shuffle(seed=11))

out["sort_desc"] = ids(base.sort("sq", descending=True))
out["sort_str"] = ids(base.sort("s"))
out["sort_two"] = ids(base.sort(["s", "sq"], descending=True))

vals = rd.range(300, parallelism=6).map(
    lambda r: {"k": r["id"] % 7, "ks": "g%d" % (r["id"] % 5), "v": ((r["id"] * 37) % 101) / 7.0 - 5.0})
every = lambda: [agg.Count(), agg.Sum("v"), agg.Min("v"), agg.Max("v"), agg.Mean("v"), agg.Std("v"),
                 agg.AbsMax("v")]
out["groupby_int"] = rows(vals.groupby("k").aggregate(*every()))
out["groupby_str"] = rows(vals.groupby("ks").aggregate(*every()))
out["aggregate"] = plain(vals.aggregate(*every()))
out["map_groups"] = rows(vals.groupby("ks").map_groups(
    lambda g: {"ks": g["ks"][:1], "n": [len(g["v"])], "first": g["v"][:1]}))

a = rd.range(30, parallelism=3)
b = rd.range(30, parallelism=2).map(lambda r: {"id": r["id"] * 10, "t": "t%d" % r["id"]})
out["union"] = rows(a.union(b, a))
out["zip"] = rows(a.zip(b))

out["split"] = [ids(s) for s in base.split(3)]
out["split_equal"] = [ids(s) for s in base.split(3, equal=True)]
out["train_test"] = [ids(s) for s in base.train_test_split(0.25)]
out["train_test_shuffled"] = [ids(s) for s in base.train_test_split(0.25, shuffle=True, seed=3)]

its = rd.range(90, parallelism=7).streaming_split(2, equal=True)
got = [[], []]


def consume(i):
    for batch in its[i].iter_batches(batch_size=10, prefetch_batches=0):
        got[i].extend(int(x) for x in batch["id"])


ts = [threading.Thread(target=consume, args=(i,)) for i in range(2)]
[t.start() for t in ts]
[t.join(timeout=120) for t in ts]
out["streaming_split"] = got

out["read_numpy"] = rows(tokens)
out["read_text"] = rows(rd.read_text(P("text")))
out["read_binary"] = rows(rd.read_binary_files(P("binary"), include_paths=False))
out["read_tfrecords"] = rows(rd.read_tfrecords(P("data.tfrecord")))
out["read_avro"] = rows(rd.read_avro(P("data.avro")))
out["read_json"] = rows(rd.read_json(P("json")))
out["read_csv"] = rows(rd.read_csv(P("csv")))
out["read_parquet"] = rows(rd.read_parquet(P("parquet")))
out["read_webdataset"] = rows(rd.read_webdataset(P("shard.tar")))
out["read_xml"] = rows(rd.read_xml(P("rows.xml"), record_tag="item"))
out["read_audio"] = rows(rd.read_audio(P("tone.wav")))
out["read_sql"] = rows(rd.read_sql("SELECT * FROM t", lambda: sqlite3.connect(P("t.db"))))
out["read_orc"] = rows(rd.read_orc(P("data.orc")))
out["read_feather"] = rows(rd.read_feather(P("data.feather")))
out["read_images"] = rows(rd.read_images(P("images")))

w = os.path.join(inputs, "written_" + pkg)
mixed = base.map(lambda r: {"id": r["id"], "s": r["s"], "x": r["sq"] / 3.0})
for fmt, write, read in (("parquet", mixed.write_parquet, rd.read_parquet),
                         ("csv", mixed.write_csv, rd.read_csv),
                         ("json", mixed.write_json, rd.read_json)):
    write(os.path.join(w, fmt))
    out["write_" + fmt] = rows(read(os.path.join(w, fmt)))
tokens.write_numpy(os.path.join(w, "npy"), column="tokens")
out["write_numpy"] = rows(rd.read_numpy(os.path.join(w, "npy"), column="tokens"))

rt.shutdown()
with open(out_path, "wb") as f:
    pickle.dump(out, f)
print("DONE")
'''


def _inputs(d: Path) -> None:
    """Every reader's files, from numpy seeds."""
    import sqlite3
    import wave

    import pyarrow as pa
    from PIL import Image
    from pyarrow import csv, orc, parquet as pq

    from test_torch_data import write_tfrecord
    from test_torch_data_sources import _make_shard, avro_file

    rng = np.random.RandomState(5)
    (d / "numpy").mkdir()
    for i in range(4):
        np.save(d / "numpy" / f"part-{i}.npy", rng.randint(0, 50304, (9, 17)).astype(np.int32))
    (d / "text").mkdir()
    for i in range(2):
        (d / "text" / f"f{i}.txt").write_text("".join(f"line {i}-{j}\n" + ("\n" if j % 3 == 0 else "")
                                                      for j in range(8)))
    (d / "binary").mkdir()
    for i in range(3):
        (d / "binary" / f"b{i}.bin").write_bytes(rng.bytes(5 + i) + b"\x00")
    write_tfrecord(d / "data.tfrecord", [{"label": [int(x)], "name": f"n{i}".encode()}
                                         for i, x in enumerate(rng.randint(-9, 9, 6))])
    (d / "data.avro").write_bytes(avro_file([{"a": int(x), "b": f"row-{x}"} for x in rng.randint(-99, 99, 12)],
                                            deflate=True))
    (d / "json").mkdir()
    with open(d / "json" / "rows.jsonl", "w") as f:
        for i in range(10):
            f.write(json.dumps({"i": i, "f": float(rng.rand()), "s": f"v{i}", "l": [i, 2 * i],
                                "d": {"q": i % 2}}) + "\n")
    table = pa.table({"i": list(range(12)), "f": rng.rand(12).tolist(), "s": [f"s{i}" for i in range(12)]})
    (d / "csv").mkdir()
    csv.write_csv(table, d / "csv" / "t.csv")
    (d / "parquet").mkdir()
    pq.write_table(table, d / "parquet" / "t.parquet", row_group_size=5)
    orc.write_table(table, str(d / "data.orc"))
    with pa.OSFile(str(d / "data.feather"), "wb") as sink, pa.ipc.new_file(sink, table.schema) as w:
        w.write_table(table)
    _make_shard(str(d / "shard.tar"), n=5)
    (d / "rows.xml").write_text("<rows>" + "".join(f"<item id='{i}'><name>n{i}</name></item>" for i in range(4))
                                + "</rows>")
    with wave.open(str(d / "tone.wav"), "wb") as wv:
        wv.setnchannels(2)
        wv.setsampwidth(2)
        wv.setframerate(8000)
        wv.writeframes(rng.randint(-3000, 3000, (400, 2)).astype(np.int16).tobytes())
    conn = sqlite3.connect(d / "t.db")
    conn.execute("CREATE TABLE t (id INTEGER, name TEXT, score REAL, raw BLOB)")
    conn.executemany("INSERT INTO t VALUES (?, ?, ?, ?)",
                     [(i, f"n{i}", float(rng.rand()), rng.bytes(3)) for i in range(8)])
    conn.commit()
    conn.close()
    (d / "images").mkdir()
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (5, 4, 3)).astype(np.uint8)).save(d / "images" / f"i{i}.png")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    inputs = tmp_path_factory.mktemp("data_parity")
    _inputs(inputs)
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    procs = {}
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-c", WORKLOAD, pkg, str(inputs), str(inputs / f"{pkg}.pkl")],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for pkg, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=400)
        finally:
            proc.kill()
        assert proc.returncode == 0 and "DONE" in stdout, stdout[-3000:] + stderr[-5000:]
        with open(inputs / f"{pkg}.pkl", "rb") as f:
            out[pkg] = pickle.load(f)
    return out


EXACT = [
    "pipeline", "shuffle_range", "shuffle_tokens", "shuffle_map", "sort_desc", "sort_str", "sort_two",
    "map_groups", "union", "zip", "split", "split_equal", "train_test", "train_test_shuffled",
    "streaming_split", "read_numpy", "read_text", "read_binary", "read_tfrecords", "read_avro", "read_json",
    "read_csv", "read_parquet", "read_webdataset", "read_xml", "read_audio", "read_sql", "read_orc",
    "read_feather", "read_images", "write_parquet", "write_csv", "write_json", "write_numpy",
]


@pytest.mark.parametrize("case", EXACT)
def test_case_equal(results, case):
    ref, port = results["ray_tpu"][case], results["ray_tpu_torch"][case]
    assert port == ref
    assert ref, f"{case}: the reference produced nothing, the case checks nothing"


def test_shuffle_reorders(results):
    got = results["ray_tpu_torch"]
    assert got["shuffle_range"] != list(range(1000)) and sorted(got["shuffle_range"]) == list(range(1000))
    assert got["shuffle_tokens"] != got["read_numpy"]
    assert sorted(map(str, got["shuffle_tokens"])) == sorted(str(r["tokens"]) for r in got["read_numpy"])


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0) or (math.isnan(a) and math.isnan(b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("case", ["groupby_int", "groupby_str", "aggregate"])
def test_aggregates_match(results, case):
    ref, port = results["ray_tpu"][case], results["ray_tpu_torch"][case]
    ref_rows = ref if isinstance(ref, list) else [ref]
    port_rows = port if isinstance(port, list) else [port]
    assert len(port_rows) == len(ref_rows) > 0
    for r, p in zip(ref_rows, port_rows):
        assert list(p) == list(r)
        for k in r:
            assert _close(p[k], r[k]), (case, k, p[k], r[k])


def test_streaming_split_is_equal(results):
    a, b = results["ray_tpu_torch"]["streaming_split"]
    assert len(a) == len(b) == 45 and sorted(a + b) == list(range(90))
