"""ray_tpu_torch.ops.fused_ce vs ray_tpu.ops.fused_ce, on the CPU.

Both entry points (with and without the logit bias) take the same numpy
inputs and cotangent; losses and dx/dw/db are compared for one chunk, the
automatic chunking (4 chunks at vocab 16384) and an explicit divisor. fp32
within 1e-5 (losses) and 1e-5 (gradients, O(1e-3) in size here): the
frameworks sum the chunk products in different orders. bf16 activations:
the chunk products are exact fp32 products of bf16 values on both sides;
dx is rounded to bf16 (one step is 2^-7 of its magnitude), so it is held
within 1e-2 of max(1, |reference|) elementwise, the rest as in fp32 times 10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import fused_ce as ref
from ray_tpu_torch.ops import fused_ce as port

N, D, V = 24, 16, 16384


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    other files' runtime tests time their worker start-ups."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(seed, dtype):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, D).astype(np.float32)
    w = (rng.randn(D, V) * 0.5).astype(np.float32)
    b = rng.randn(V).astype(np.float32)
    t = rng.randint(0, V, N).astype(np.int32)
    g = rng.rand(N).astype(np.float32)
    return x, w, b, t, g


@pytest.fixture(scope="module")
def reference_results():
    """Losses and gradients of the JAX entry points, per (dtype, bias, n_chunks)."""
    cache = {}

    def get(dtype, bias, n_chunks):
        key = (dtype, bias, n_chunks)
        if key not in cache:
            x, w, b, t, g = _inputs(0, dtype)
            jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
            if bias:
                def f(x, w, b):
                    return ref.fused_softmax_cross_entropy_bias(x, w, b, jnp.asarray(t), n_chunks)
                args = (jx, jnp.asarray(w), jnp.asarray(b))
            else:
                def f(x, w):
                    return ref.fused_softmax_cross_entropy(x, w, jnp.asarray(t), n_chunks)
                args = (jx, jnp.asarray(w))
            losses, vjp = jax.vjp(f, *args)
            cache[key] = (np.asarray(losses), [np.asarray(a.astype(jnp.float32)) for a in vjp(jnp.asarray(g))])
        return cache[key]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("n_chunks", [1, None, 8])
def test_losses_and_grads_match_reference(reference_results, dtype, bias, n_chunks):
    want_losses, want_grads = reference_results(dtype, bias, n_chunks)
    x, w, b, t, g = _inputs(0, dtype)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    leaves = [tx.requires_grad_(True), torch.from_numpy(w).requires_grad_(True)]
    if bias:
        leaves.append(torch.from_numpy(b).requires_grad_(True))
        losses = port.fused_softmax_cross_entropy_bias(*leaves, torch.from_numpy(t), n_chunks)
    else:
        losses = port.fused_softmax_cross_entropy(*leaves, torch.from_numpy(t), n_chunks)
    got = torch.autograd.grad(losses, leaves, torch.from_numpy(g))
    assert losses.dtype == torch.float32 and losses.shape == (N,)
    scale = 10.0 if dtype == "bfloat16" else 1.0
    np.testing.assert_allclose(losses.detach().numpy(), want_losses, rtol=1e-5 * scale, atol=1e-5 * scale)
    for i, (a, e) in enumerate(zip(got, want_grads)):
        assert a.dtype == leaves[i].dtype
        a = a.float().numpy()
        if i == 0 and dtype == "bfloat16":  # dx comes back in bf16
            assert (np.abs(a - e) <= 1e-2 * np.maximum(1.0, np.abs(e))).all()
        else:
            np.testing.assert_allclose(a, e, atol=1e-5 * scale)


def test_auto_chunking_matches_reference():
    for vocab in (512, 8192, 16384, 50304, 50400, 3000):
        assert port._pick_chunks(vocab, None) == ref._pick_chunks(vocab, None)
    assert port._pick_chunks(V, None) == 4  # the auto case above runs 4 chunks


def test_non_divisor_chunks_raise():
    x, w, b, t, _ = _inputs(1, "float32")
    with pytest.raises(ValueError, match="must divide vocab"):
        port.fused_softmax_cross_entropy(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t), 5)
    with pytest.raises(ValueError, match="must divide vocab"):
        port.fused_softmax_cross_entropy_bias(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(t), 3)
