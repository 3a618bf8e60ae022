"""ray_tpu_torch.ops.paged_attention vs the JAX reference, on the CPU.

The port's plain decode, verify and prefill paths take the same numpy
inputs as ``ray_tpu.ops.paged_attention``'s XLA paths and its Pallas decode
and verify kernels (run in interpret mode, as tests/test_llm_engine.py and
tests/test_llm_spec.py run them), fp32, atol 2e-5 — the reference's own
Pallas-vs-XLA tolerance. The CUDA kernels themselves run only on a GPU;
chip_smoke.py holds them against the plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops import paged_attention as ref_ops
from ray_tpu_torch.ops import paged_attention as ops

ATOL = 2e-5


def _case(seed=0, slots=3, heads=4, d=16, blocks=12, bs=4, tmax=6):
    rng = np.random.RandomState(seed)
    q = rng.randn(slots, heads, d).astype(np.float32)
    kp = rng.randn(blocks, heads, bs, d).astype(np.float32)
    vp = rng.randn(blocks, heads, bs, d).astype(np.float32)
    bt = rng.randint(0, blocks, (slots, tmax)).astype(np.int32)
    lens = rng.randint(1, tmax * bs + 1, slots).astype(np.int32)
    return q, kp, vp, bt, lens


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_decode_matches_reference(seed, ref_impl):
    case = _case(seed)
    ref = np.asarray(ref_ops.paged_attention(*_jax(*case), impl=ref_impl))
    out = ops.paged_attention(*_port(*case)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_decode_impls_agree_and_auto_is_plain_on_cpu():
    case = _port(*_case(3))
    auto = ops.paged_attention(*case)
    plain = ops.paged_attention(*case, impl="torch")
    assert torch.equal(auto, plain)


def test_prefill_matches_reference():
    rng = np.random.RandomState(5)
    chunk, heads, d, blocks, bs, tmax = 6, 4, 16, 12, 4, 6
    q = rng.randn(chunk, heads, d).astype(np.float32)
    kp = rng.randn(blocks, heads, bs, d).astype(np.float32)
    vp = rng.randn(blocks, heads, bs, d).astype(np.float32)
    table = rng.randint(0, blocks, tmax).astype(np.int32)
    positions = (7 + np.arange(chunk)).astype(np.int32)
    ref = np.asarray(ref_ops.paged_prefill_attention_xla(*_jax(q, kp, vp, table, positions)))
    out = ops.paged_prefill_attention_torch(*_port(q, kp, vp, table, positions)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_trash_padding_is_masked():
    """Table entries past a slot's length point at trash block 0; their
    contents must not change the output."""
    q, kp, vp, _, _ = _case(11)
    lens = np.array([5, 9, 1], np.int32)  # 2, 3 and 1 live blocks of 4
    live = -(-lens // 4)
    bt = np.random.RandomState(11).randint(1, kp.shape[0], (3, 6))  # never the trash block
    bt = np.where(np.arange(6)[None, :] < live[:, None], bt, 0).astype(np.int32)
    a = ops.paged_attention(*_port(q, kp, vp, bt, lens))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0] = 1e3
    vp2[0] = -1e3
    b = ops.paged_attention(*_port(q, kp2, vp2, bt, lens))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_zero_length_row_is_finite():
    q, kp, vp, bt, lens = _case(2)
    lens[1] = 0
    out = ops.paged_attention(*_port(q, kp, vp, bt, lens))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize(
    "tmax, block_size, expected",
    [(128, 16, (128, 16)), (32, 16, (128, 4)), (40, 4, (128, 2)), (7, 48, (96, 4)), (5, 256, (256, 5))],
)
def test_decode_splits(tmax, block_size, expected):
    """The split is the whole number of blocks nearest SPLIT_TOKENS from
    below (one block at least), and the splits cover the table; the first
    case is the serving config (tmax 128, block 16)."""
    assert ops.decode_splits(tmax, block_size) == expected


_SPLIT_TMAX, _SPLIT_BS = 40, 4
_SPLIT = ops.decode_splits(_SPLIT_TMAX, _SPLIT_BS)[0]


@pytest.mark.parametrize(
    "length", [0, 1, _SPLIT - 1, _SPLIT, _SPLIT + 1, _SPLIT_TMAX * _SPLIT_BS],
    ids=["zero", "one", "split-1", "split", "split+1", "full-table"],
)
def test_split_partials_merge_to_the_reference(length):
    """The decode kernel's two passes in plain PyTorch: per-split partial
    states merged over the live splits equal ``paged_attention_torch`` and
    the reference's ``paged_attention`` (fp32, 1e-5). Splits with no live
    position are filled with NaN first: the merge must never read them. A
    zero-length slot merges to zeros."""
    rng = np.random.RandomState(length + 1)
    slots, heads, d, blocks = 3, 2, 16, 3 * _SPLIT_TMAX
    q = rng.randn(slots, heads, d).astype(np.float32)
    kp = rng.randn(blocks, heads, _SPLIT_BS, d).astype(np.float32)
    vp = rng.randn(blocks, heads, _SPLIT_BS, d).astype(np.float32)
    bt = rng.permutation(blocks)[: slots * _SPLIT_TMAX].reshape(slots, _SPLIT_TMAX).astype(np.int32)
    lens = np.array([length, rng.randint(1, _SPLIT_TMAX * _SPLIT_BS + 1), length], np.int32)
    tq, tk, tv, tb, tl = _port(q, kp, vp, bt, lens)
    parts = ops.decode_partials_torch(tq, tk, tv, tb, tl, _SPLIT)
    assert parts.shape == (slots, heads, ops.decode_splits(_SPLIT_TMAX, _SPLIT_BS)[1], d + 2)
    dead = torch.arange(parts.shape[2])[None, :] * _SPLIT >= tl.long()[:, None]
    parts[dead[:, None, :].expand(-1, heads, -1)] = float("nan")
    out = ops.merge_decode_partials_torch(parts, tl, _SPLIT, tq.dtype)
    assert torch.isfinite(out).all()
    live = lens > 0
    ref = np.asarray(ref_ops.paged_attention(*_jax(q, kp, vp, bt, lens), impl="xla"))
    np.testing.assert_allclose(out.numpy()[live], ref[live], atol=1e-5)
    plain = ops.paged_attention_torch(tq, tk, tv, tb, tl)
    torch.testing.assert_close(out[live], plain[live], rtol=0, atol=1e-5)
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))


def test_cuda_impl_on_cpu_tensor_raises():
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.paged_attention(*_port(*_case(0)), impl="cuda")


def test_bad_impl_rejected():
    with pytest.raises(ValueError, match="unknown paged attention impl"):
        ops.paged_attention(*_port(*_case(0)), impl="pallas")


# ---------------------------------------------------------------------------
# multi-query verify attention (the speculative-decode window)
# ---------------------------------------------------------------------------


def _verify_case(seed=0, slots=3, w=4, heads=4, d=16, blocks=12, bs=4, tmax=6, base=None):
    """tests/test_llm_spec.py's shapes: consecutive windows of w positions."""
    rng = np.random.RandomState(seed)
    q = rng.randn(slots, w, heads, d).astype(np.float32)
    kp = rng.randn(blocks, heads, bs, d).astype(np.float32)
    vp = rng.randn(blocks, heads, bs, d).astype(np.float32)
    bt = rng.randint(0, blocks, (slots, tmax)).astype(np.int32)
    if base is None:
        base = rng.randint(0, tmax * bs - w, slots)
    pos = (np.asarray(base)[:, None] + np.arange(w)[None, :]).astype(np.int32)
    return q, kp, vp, bt, pos


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_verify_matches_reference(seed, ref_impl):
    case = _verify_case(seed)
    ref = np.asarray(ref_ops.paged_verify_attention(*_jax(*case), impl=ref_impl))
    out = ops.paged_verify_attention(*_port(*case)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_verify_window_past_the_table_matches_reference():
    """A slot one emit away from the length cap feeds positions past
    tmax*bs: the live cache ends at the table's reach."""
    case = _verify_case(3, base=[6 * 4 - 2, 5, 6 * 4 - 4])  # last positions 25, 8, 23
    assert case[4][:, -1].max() >= 6 * 4
    ref = np.asarray(ref_ops.paged_verify_attention(*_jax(*case), impl="xla"))
    out = ops.paged_verify_attention(*_port(*case)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_verify_window_index_is_a_decode_step():
    """Window index i equals single-query decode attention at length
    positions[:, i] + 1 — the verify op IS w stacked decode steps."""
    q, kp, vp, bt, pos = _port(*_verify_case(5))
    out = ops.paged_verify_attention(q, kp, vp, bt, pos)
    for i in range(q.shape[1]):
        one = ops.paged_attention_torch(q[:, i], kp, vp, bt, pos[:, i] + 1)
        torch.testing.assert_close(out[:, i], one, rtol=0, atol=ATOL)


def test_verify_inactive_slot_is_finite():
    """An empty slot carries base 0 and an all-trash table."""
    q, kp, vp, bt, pos = _verify_case(9, base=[0, 7, 3])
    bt[0] = 0
    out = ops.paged_verify_attention(*_port(q, kp, vp, bt, pos))
    assert torch.isfinite(out).all()


def test_verify_impls_and_errors():
    case = _port(*_verify_case(2))
    assert torch.equal(ops.paged_verify_attention(*case), ops.paged_verify_attention(*case, impl="torch"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.paged_verify_attention(*case, impl="cuda")
    with pytest.raises(ValueError, match="unknown paged attention impl"):
        ops.paged_verify_attention(*case, impl="pallas")


@pytest.mark.parametrize("w", [9, 17])
@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_verify_wide_windows_match_reference(w, ref_impl):
    """Windows past the first kernel's widest (8) and past one 16-row query
    tile: the plain version against the reference."""
    case = _verify_case(w + 1, w=w, tmax=10)
    ref = np.asarray(ref_ops.paged_verify_attention(*_jax(*case), impl=ref_impl))
    out = ops.paged_verify_attention(*_port(*case)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


_VSPLIT_TMAX, _VSPLIT_BS = 24, 4
# a split of 8 blocks: three splits over the small table (the kernels' own
# split, decode_splits, would cover it whole)
_VSPLIT = 8 * _VSPLIT_BS
_VFULL = _VSPLIT_TMAX * _VSPLIT_BS
# the live length of the case's slots (the last query's position + 1): an
# inactive slot (base 0, an all-trash table), lengths on and next to the
# split edges, the full table, and a window past the table's reach
_VLENGTHS = {"inactive": None, "one": 1, "split-1": _VSPLIT - 1, "split": _VSPLIT,
             "split+1": _VSPLIT + 1, "full-table": _VFULL, "past-the-table": _VFULL + 3}


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("length", list(_VLENGTHS), ids=list(_VLENGTHS))
@pytest.mark.parametrize("w", [1, 2, 5, 9, 17])
def test_verify_split_partials_merge_to_the_reference(w, length, d):
    """The verify kernel's two passes in plain PyTorch: per-split partial
    states of every query of the window, merged over the slot's live splits,
    equal the reference's ``paged_verify_attention`` (XLA, and Pallas in
    interpret mode) and ``paged_verify_attention_torch`` (fp32, 1e-5).
    Splits with no live position are filled with NaN first: the merge must
    never read them. Windows 9 and 17 pass the first kernel's widest (8) and
    one 16-row query tile; a window shorter than its slot's start is placed
    at base 0, as the engine places an empty slot."""
    rng = np.random.RandomState(7 * w + d)
    slots, heads, blocks = 3, 2, 3 * _VSPLIT_TMAX
    q = rng.randn(slots, w, heads, d).astype(np.float32)
    kp = rng.randn(blocks, heads, _VSPLIT_BS, d).astype(np.float32)
    vp = rng.randn(blocks, heads, _VSPLIT_BS, d).astype(np.float32)
    bt = rng.permutation(blocks)[: slots * _VSPLIT_TMAX].reshape(slots, _VSPLIT_TMAX).astype(np.int32)
    n = _VLENGTHS[length]
    if n is None:
        n = w
        bt[[0, 2]] = 0  # all-trash tables
    base = np.array([max(n - w, 0), rng.randint(0, _VFULL - w + 1), max(n - w, 0)])
    pos = (base[:, None] + np.arange(w)[None, :]).astype(np.int32)
    tq, tk, tv, tb, tp = _port(q, kp, vp, bt, pos)
    parts = ops.verify_partials_torch(tq, tk, tv, tb, tp, _VSPLIT)
    splits = -(-_VSPLIT_TMAX * _VSPLIT_BS // _VSPLIT)
    assert parts.shape == (slots, heads, splits, w, d + 2)
    live_len = (tp[:, -1].long() + 1).clamp(max=_VFULL)
    dead = torch.arange(splits)[None, :] * _VSPLIT >= live_len[:, None]
    parts[dead[:, None, :].expand(-1, heads, -1)] = float("nan")
    out = ops.merge_verify_partials_torch(parts, tp, _VSPLIT, tq.dtype)
    assert out.shape == tq.shape and torch.isfinite(out).all()
    for impl in ("xla", "pallas"):
        ref = np.asarray(ref_ops.paged_verify_attention(*_jax(q, kp, vp, bt, pos), impl=impl))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, err_msg=impl)
    plain = ops.paged_verify_attention_torch(tq, tk, tv, tb, tp)
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-5)
