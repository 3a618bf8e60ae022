"""``iter_torch_batches(sharding=NamedSharding(mesh, batch_spec()))`` (the
port's ``iter_jax_batches(sharding=...)``) on gloo meshes of 2 and 4
ranks, against the reference's ``iter_jax_batches(sharding=NamedSharding(
Mesh(8 devices), P("data")))`` over conftest's 8 virtual CPU devices.

Each rank's shard of every batch is its slice of the reference's global
values (dtypes applied before placement), every batch is a ``DTensor`` of
the global shape, ``build_train_step(..., mesh)`` takes the batches as
they come (its losses equal the same batches fed as host arrays, bit for
bit), a local shuffle without a seed on a mesh of several processes
raises naming the seed, a seeded one gives the ranks one consistent batch,
and a sharding that is not a ``NamedSharding`` raises a ``TypeError``. The
ranks are one launch of ``tests/torch_ranks.py``; the reference runs in
this process meanwhile.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import ray_tpu
from ray_tpu import data as ref_data
from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.models.gpt import gpt_init as ref_gpt_init
from torch_ranks import Ranks

pytestmark = pytest.mark.skipif(
    len(jax.devices("cpu")) < 8, reason="the reference's sharded batches need conftest's 8 virtual CPU devices")

BATCH = 16  # divides over 2, 4 and the reference's 8 devices
FILES, ROWS_PER_FILE = 5, 11  # 55 rows: batches straddle files; the last 7 rows dropped
GPT_KW = dict(vocab_size=64, seq_len=8, d_model=32, n_layers=1, n_heads=2, dtype="float32")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(23)
    tokens = rng.integers(0, GPT_KW["vocab_size"], (FILES * ROWS_PER_FILE, GPT_KW["seq_len"] + 1)).astype(np.int32)
    files = []
    for i in range(FILES):
        files.append(str(d / f"part-{i:02d}.npy"))
        np.save(files[-1], tokens[i * ROWS_PER_FILE:(i + 1) * ROWS_PER_FILE])
    return files, tokens


@pytest.fixture(scope="module")
def ranks(corpus, tmp_path_factory):
    """The 4 ranks' results, and the reference's global batches, made while
    the ranks run."""
    files, _ = corpus
    tree = jax.device_get(ref_gpt_init(jax.random.PRNGKey(3), RefGPTConfig(**GPT_KW, attn_impl="xla")))
    run = Ranks(4, "sharded_batches", dict(files=files, batch=BATCH, cfg=GPT_KW, tree=tree),
                tmp_path_factory.mktemp("ranks"))
    ray_tpu.init(num_cpus=2, num_tpus=0)
    try:
        sharding = NamedSharding(Mesh(np.array(jax.devices()), ("data",)), P("data"))
        ref = [{k: np.asarray(v) for k, v in b.items()} for b in ref_data.read_numpy(files, column="tokens")
               .iter_jax_batches(batch_size=BATCH, sharding=sharding, dtypes={"tokens": np.int64}, drop_last=True)]
    finally:
        ray_tpu.shutdown()
    return run.wait(), ref


@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_holds_its_slice_of_the_reference_batches(ranks, n):
    out, ref = ranks
    assert len(ref) == FILES * ROWS_PER_FILE // BATCH
    per = BATCH // n
    for rank in range(n):
        got = out[rank][n]
        assert got["dtensor"] and got["dtypes"] == {"torch.int64"}
        assert got["shapes"] == [b["tokens"].shape for b in ref]
        assert len(got["local"]) == len(ref)
        for local, want in zip(got["local"], ref):
            np.testing.assert_array_equal(local, want["tokens"][rank * per:(rank + 1) * per])
    assert all(n not in out[rank] for rank in range(n, 4))  # ranks outside the mesh read nothing


@pytest.mark.parametrize("n", [2, 4])
def test_the_mesh_step_takes_sharded_batches_as_they_come(ranks, n):
    """``build_train_step(..., mesh)`` on the iterator's ``DTensor``
    batches: the same losses, bit for bit, as the same batches fed as host
    arrays (which the step slices itself), equal on every rank."""
    out, _ = ranks
    losses = [out[rank][n]["losses"] for rank in range(n)]
    assert len(losses[0]["sharded"]) == FILES * ROWS_PER_FILE // BATCH
    assert all(np.isfinite(losses[0]["sharded"]))
    for got in losses:
        assert got["sharded"] == got["host"] == losses[0]["sharded"]


def test_unseeded_shuffle_and_a_foreign_sharding_raise_and_a_seeded_shuffle_agrees(ranks, corpus):
    out, _ = ranks
    _, tokens = corpus
    corpus_rows = {tuple(r) for r in tokens.tolist()}
    for n in (2, 4):
        for rank in range(n):
            assert "local_shuffle_seed" in out[rank][n]["unseeded_shuffle"]
            assert "NamedSharding" in out[rank][n]["wrong_type"]
        # the ranks' shards of each seeded batch are disjoint rows of the corpus
        for b in range(FILES * ROWS_PER_FILE // BATCH):
            rows = [tuple(r) for rank in range(n) for r in out[rank][n]["seeded_rows"][b]]
            assert len(rows) == BATCH and len(set(rows)) == BATCH and set(rows) <= corpus_rows
