"""``ops.flash_attention.flash_attention_sharded`` against the reference's
on the CPU — a mirror of ``tests/test_attention.py::
test_flash_sharded_matches_dense``: on a (dp 2, tp 2) mesh of gloo ranks
(``tests/torch_ranks.py``) each rank attends its own shard (batch over dp,
heads over tp) with the flash path's plain version (the kernels run on the
card), and the gathered output and gradients must agree with dense
attention (the reference's ``_xla_attention``) and with the reference's
sharded Pallas kernel in interpret mode, within the reference's own
2e-5 (output) and 5e-5 (gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from ray_tpu.ops.attention import _xla_attention
from ray_tpu.ops.flash_attention import flash_attention_sharded as ref_flash_attention_sharded
from ray_tpu.ops.flash_attention import flash_shardable as ref_flash_shardable
from torch_ranks import run_ranks


def _qkv(b=2, h=4, s=128, d=32, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return [jax.random.normal(k, (b, h, s, d), jnp.float32) for k in ks]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    q, k, v = (np.asarray(t) for t in _qkv())
    w = np.asarray(jnp.cos(jnp.arange(32)), np.float32)
    return run_ranks(4, "flash_sharded", dict(q=q, k=k, v=v, w=w), tmp_path_factory.mktemp("flash_sharded"))


def test_flash_sharded_matches_dense(ranks):
    q, k, v = _qkv()
    devs = np.array(jax.devices()[:4]).reshape(2, 1, 2, 1)
    mesh = Mesh(devs, ("dp", "fsdp", "tp", "sp"))
    assert ref_flash_shardable(2, 4, mesh) and not ref_flash_shardable(3, 4, mesh)
    assert not ref_flash_shardable(2, 3, mesh)
    ref = _xla_attention(q, k, v)
    w = jnp.cos(jnp.arange(32))
    g_ref = jax.grad(lambda q, k, v: (_xla_attention(q, k, v) * w).sum(), argnums=(0, 1, 2))(q, k, v)
    with mesh:
        ref_sharded = jax.jit(lambda q, k, v: ref_flash_attention_sharded(q, k, v, mesh))(q, k, v)
    for r in ranks:
        assert r["shardable"] == [ref_flash_shardable(b, h, mesh) for b, h in ((2, 4), (3, 4), (2, 3))]
        assert r["local_shapes"] == [(1, 2, 128, 32)]  # one batch row, two heads: its shard only
        assert r["placements"] == ["S(0)", "S(0)", "R", "R", "S(1)"]  # batch over (dp, fsdp), heads over tp
        np.testing.assert_allclose(r["out"], np.asarray(ref), atol=2e-5)
        np.testing.assert_allclose(r["out"], np.asarray(ref_sharded), atol=2e-5)
        for got, want in zip(r["grads"], g_ref):
            np.testing.assert_allclose(got, np.asarray(want), atol=5e-5)
