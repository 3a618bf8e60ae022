"""ray_tpu_torch.models.gptj vs ray_tpu.models.gptj, on the CPU.

The reference's ``gptj_init(PRNGKey(0), TINY)`` weights are carried over
with ``params_from_jax``; the same numpy tokens go through both forwards
(fp32 logits within 1e-4: the two frameworks sum matmuls and softmaxes in
different orders) and both greedy decoders (token for token).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gptj as ref
from ray_tpu_torch.models import gptj as port

TINY_REF = ref.GPTJConfig(
    vocab_size=128, seq_len=64, d_model=32, n_layers=2, n_heads=2,
    rotary_dim=8, dtype="float32", remat=False, attn_impl="xla",
    fused_loss=False,
)
TINY = port.GPTJConfig(
    vocab_size=128, seq_len=64, d_model=32, n_layers=2, n_heads=2, rotary_dim=8, dtype="float32"
)


@pytest.fixture(scope="module")
def ref_params():
    return ref.gptj_init(jax.random.PRNGKey(0), TINY_REF)


@pytest.fixture(scope="module")
def port_params(ref_params):
    return port.params_from_jax(jax.device_get(ref_params), TINY, "cpu")


def test_params_from_jax_layout(ref_params, port_params):
    tree = jax.device_get(ref_params)
    blk = port_params.blocks[1]
    np.testing.assert_array_equal(blk.q.weight.numpy(), tree["blocks"]["q"]["kernel"][1].T)
    np.testing.assert_array_equal(blk.mlp_in.bias.numpy(), tree["blocks"]["mlp_in"]["bias"][1])
    np.testing.assert_array_equal(port_params.lm_head.weight.numpy(), tree["lm_head"]["kernel"].T)
    assert port_params.lm_head.weight.dtype == torch.float32
    assert not any(p.requires_grad for p in port_params.parameters())


@pytest.mark.parametrize("seed,shape", [(1, (2, 10)), (2, (1, 33))])
def test_forward_matches_reference(ref_params, port_params, seed, shape):
    tokens = np.random.RandomState(seed).randint(0, TINY.vocab_size, shape)
    want = np.asarray(ref.gptj_forward(TINY_REF, ref_params, jnp.asarray(tokens, jnp.int32)))
    got = port.gptj_forward(TINY, port_params, torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("seed,prompt_len,n_new", [(1, 10, 8), (3, 5, 12)])
def test_greedy_decode_matches_reference(ref_params, port_params, seed, prompt_len, n_new):
    prompt = np.random.RandomState(seed).randint(0, TINY.vocab_size, (1, prompt_len))
    want = np.asarray(ref.gptj_decode(TINY_REF, ref_params, jnp.asarray(prompt, jnp.int32), n_new))
    got = port.gptj_decode(TINY, port_params, torch.from_numpy(prompt), n_new).numpy()
    assert got.tolist() == want.tolist()


def test_rotary_matches_reference():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 5, 16).astype(np.float32)
    positions = np.arange(5)
    sin, cos = ref._rotary_sincos(jnp.asarray(positions), 8)
    want = np.asarray(ref._apply_rotary(jnp.asarray(x), sin, cos, 8))
    psin, pcos = port._rotary_sincos(torch.from_numpy(positions), 8)
    got = port._apply_rotary(torch.from_numpy(x), psin, pcos, 8).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_bf16_storage_and_random_init():
    cfg = dataclasses.replace(TINY, dtype="bfloat16")
    a = port.gptj_init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = port.gptj_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert a.blocks[0].q.weight.dtype == torch.bfloat16
    assert a.embed.weight.dtype == torch.bfloat16
    assert a.ln_f.scale.dtype == torch.float32 and a.lm_head.bias.dtype == torch.float32
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)  # seeded: reproducible
    std = a.blocks[0].mlp_out.weight.float().std().item()
    assert abs(std - cfg.d_ff**-0.5) < 0.2 * cfg.d_ff**-0.5
    logits = port.gptj_forward(cfg, a, torch.tensor([[1, 2, 3]]))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
