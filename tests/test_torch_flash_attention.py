"""ray_tpu_torch.ops.flash_attention vs ray_tpu.ops.flash_attention, on the CPU.

The reference's Pallas kernels run in interpret mode (as its own tests run
them off the TPU); the port's plain versions — the CPU path of
``FlashAttention`` and what K3-K5 are held against on the card — take the
same numpy inputs. Tolerances: fp32 out 2e-5 and grads 1e-4 (summation
order only); bf16 1e-2 x max(1, |reference|) elementwise, because both sides
round one fp32 value to bf16 and a different summation order can move it by
one bf16 step, which is 2^-7 of the value's magnitude (2^-6 = 0.0156 at
magnitudes 2-4, which attention outputs reach on early rows).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import flash_attention as ref
from ray_tpu_torch.ops import flash_attention as port
from ray_tpu_torch.ops.attention import _xla_attention, causal_attention

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL_OUT = {"float32": 2e-5, "bfloat16": 1e-2}
TOL_GRAD = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    other files' runtime tests time their worker start-ups."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    bound = tol * (np.maximum(1.0, np.abs(want)) if dtype == "bfloat16" else 1.0)
    err = np.abs(got - want)
    assert (err <= bound).all(), f"max abs error {err.max()} (tol {tol}, {dtype})"


def _inputs(seed, shape, dtype):
    """numpy fp32 arrays rounded to ``dtype`` once; the same values for both."""
    rng = np.random.RandomState(seed)
    jdt, tdt = DTYPES[dtype]
    arrays = [rng.randn(*shape).astype(np.float32) for _ in range(4)]
    return [jnp.asarray(a).astype(jdt) for a in arrays], [torch.from_numpy(a).to(tdt) for a in arrays]


CASES = [(seq, dtype) for seq in (128, 192) for dtype in DTYPES]


@pytest.mark.parametrize("seq,dtype", CASES)
def test_forward_reference_matches_pallas(seq, dtype):
    (jq, jk, jv, _), (q, k, v, _) = _inputs(seq, (4, seq, 64), dtype)
    want_out, want_lse = ref._flash_fwd(jq, jk, jv, block_q=64, block_k=64)
    out, lse = port.flash_fwd_reference(q, k, v)
    assert out.dtype == q.dtype and lse.dtype == torch.float32 and lse.shape == (4, seq)
    _close(out.float(), want_out.astype(jnp.float32), TOL_OUT[dtype], dtype)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse[:, 0]), atol=1e-5)


@pytest.mark.parametrize("seq,dtype", CASES)
def test_backward_reference_matches_pallas(seq, dtype):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(seq + 1, (4, seq, 64), dtype)
    jout, jlse = ref._flash_fwd(jq, jk, jv, block_q=64, block_k=64)
    want = ref._flash_bwd(jq, jk, jv, jout, jlse, jdo, block_q=64, block_k=64)
    # both sides take the reference forward's out and lse
    out = torch.from_numpy(np.array(jout.astype(jnp.float32))).to(q.dtype)
    lse = torch.from_numpy(np.array(jlse[:, 0]))
    got = port.flash_bwd_reference(q, k, v, out, lse, do)
    for g, w in zip(got, want):
        assert g.dtype == q.dtype
        _close(g.float(), w.astype(jnp.float32), TOL_GRAD[dtype], dtype)


@pytest.mark.parametrize("seq,dtype", CASES)
def test_autograd_matches_jax_grad(seq, dtype):
    """FlashAttention's forward and gradients (torch.autograd.grad, CPU
    path) against jax.grad of the reference flash_attention."""
    (jq, jk, jv, _), (q, k, v, _) = _inputs(seq + 2, (1, 2, seq, 64), dtype)
    w = np.cos(np.arange(64)).astype(np.float32)

    def loss(q, k, v):
        return (ref.flash_attention(q, k, v, 64, 64).astype(jnp.float32) * w).sum()

    want_out = ref.flash_attention(jq, jk, jv, 64, 64)
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    qs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = port.flash_attention(*qs)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), qs)
    _close(out.detach().float(), want_out.astype(jnp.float32), TOL_OUT[dtype], dtype)
    for g, w_ in zip(got, want):
        assert g.dtype == q.dtype
        _close(g.float(), w_.astype(jnp.float32), TOL_GRAD[dtype], dtype)


@pytest.mark.parametrize("seq,dtype", CASES)
def test_causal_attention_flash_matches_xla(seq, dtype):
    _, (q, k, v, do) = _inputs(seq + 3, (2, 2, seq, 64), dtype)
    outs, grads = [], []
    for impl in ("flash", "xla"):
        qs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = causal_attention(*qs, impl=impl)
        grads.append(torch.autograd.grad(out, qs, do))
        outs.append(out.detach())
    _close(outs[0].float(), outs[1].float(), TOL_OUT[dtype], dtype)
    if dtype == "float32":  # the einsum path rounds its probabilities to q's dtype
        for a, b in zip(*grads):
            _close(a, b, TOL_GRAD[dtype], dtype)


def test_auto_takes_the_einsum_on_the_cpu_and_checks_impl():
    _, (q, k, v, _) = _inputs(5, (1, 2, 70, 32), "float32")
    assert torch.equal(causal_attention(q, k, v), _xla_attention(q, k, v))
    with pytest.raises(ValueError, match="unknown attention impl"):
        causal_attention(q, k, v, impl="ring")


def test_kernel_wrappers_check_their_arguments():
    """On the CPU the wrappers refuse before any build: a head dim the
    kernels lack, a dtype they lack, CPU tensors."""
    q = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="head_dim"):
        port.flash_fwd_cuda(torch.zeros(2, 8, 96), torch.zeros(2, 8, 96), torch.zeros(2, 8, 96))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        h = q.half()
        port.flash_fwd_cuda(h, h, h)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        port.flash_fwd_cuda(q, q, q)
    rows = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="expected"):
        port.flash_bwd_dq_cuda(q, q, q, q, rows.double(), rows)
    assert port.flash_fwd_cuda.launches == 0


def _misaligned(shape, dtype):
    """A contiguous tensor of ``shape`` that starts one element past a
    16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("kernel,operand", [("fwd", "q"), ("fwd", "v"), ("dq", "k"), ("dkv", "do")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrappers_refuse_misaligned_operands(kernel, operand, dtype):
    """The kernels copy rows in 16-byte pieces: an operand that does not
    start at a 16-byte-aligned address is refused before the device check,
    so the CPU sees the refusal the card would give. lse and delta rows
    are read 4 bytes at a time and need no such alignment."""
    shape = (2, 8, 64)
    args = {name: torch.zeros(shape, dtype=dtype) for name in ("q", "k", "v", "do")}
    args[operand] = _misaligned(shape, dtype)
    assert args[operand].is_contiguous() and args[operand].data_ptr() % 16
    rows = _misaligned((2, 8), torch.float32)  # lse, delta: refused only for their device
    calls = {
        "fwd": lambda: port.flash_fwd_cuda(args["q"], args["k"], args["v"]),
        "dq": lambda: port.flash_bwd_dq_cuda(args["q"], args["k"], args["v"], args["do"], rows, rows),
        "dkv": lambda: port.flash_bwd_dkv_cuda(args["q"], args["k"], args["v"], args["do"], rows, rows),
    }
    with pytest.raises(ValueError, match=f"needs {operand} at a 16-byte-aligned address"):
        calls[kernel]()
    args[operand] = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        calls[kernel]()
