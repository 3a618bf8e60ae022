"""ray_tpu_torch.models.sampling vs ray_tpu.models.sampling, on the CPU.

Filtering and logprob scoring are deterministic functions of the logits
and are compared with the reference on the same numpy logits. Sampled
TOKENS are compared only in distribution: the port draws from
``torch.Generator``s keyed by (seed, output index) and cannot reproduce
``jax.random``'s bits, so the check is that the port's sampling
frequencies match the reference's filtered softmax. The same holds for
speculative verification: greedy windows match the reference exactly,
sampled ones in distribution.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import sampling as ref
from ray_tpu_torch.llm.model_runner import _row_noise, _sample_rows, _window_noise
from ray_tpu_torch.models import sampling as port

# moderate temperatures over unit-scale logits keep every tail probability
# far above fp32's resolution of 1.0: the top-p test ``cum - p < top_p`` at
# top_p = 1.0 then does not hinge on the summation order of the two
# frameworks' fp32 cumsums
TEMP = np.array([0.8, 1.0, 2.0, 0.0, 0.7], np.float32)
TOP_K = np.array([0, 5, 1, 10, 3], np.int32)
TOP_P = np.array([1.0, 0.9, 0.5, 0.3, 0.8], np.float32)


def _logits(seed, b=5, v=50):
    return np.random.RandomState(seed).randn(b, v).astype(np.float32)


def _knobs():
    return torch.from_numpy(TEMP), torch.from_numpy(TOP_K).long(), torch.from_numpy(TOP_P)


def _sample(logits, seeds, counters, temp, top_k=0, top_p=1.0):
    """Port sampling of (b, v) logits with rows keyed by (seed, counter)."""
    b, v = logits.shape
    temp = np.broadcast_to(np.asarray(temp, np.float32), (b,))
    noise = _row_noise(seeds, counters, temp, v, "cpu")
    tok, lp = _sample_rows(
        torch.as_tensor(logits), noise, temp,
        np.broadcast_to(top_k, (b,)), np.broadcast_to(np.float32(top_p), (b,)),
    )
    return tok.numpy(), lp.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filtered_logits_match_reference(seed):
    logits = _logits(seed)
    want = np.asarray(ref._filtered_logits(jnp.asarray(logits), *map(jnp.asarray, (TEMP, TOP_K, TOP_P))))
    got = port._filtered_logits(torch.from_numpy(logits), *_knobs()).numpy()
    assert np.array_equal(got <= -1e29, want <= -1e29), "different support"
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_token_logprobs_match_reference():
    logits = _logits(3)
    toks = np.argsort(-logits, axis=-1)[:, 1].astype(np.int32)  # the runner-up: inside top-k > 1
    want = np.asarray(ref.token_logprobs(jnp.asarray(logits), jnp.asarray(toks), TEMP, TOP_K, TOP_P))
    got = port.token_logprobs(torch.from_numpy(logits), torch.from_numpy(toks), *_knobs()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sampled_logprob_is_chosen_logprob():
    """sample_tokens_logprobs reports token_logprobs of what it picked."""
    logits = _logits(4)
    tok, lp = _sample(logits, np.arange(5), np.zeros(5), TEMP, TOP_K, 1.0)
    again = port.token_logprobs(torch.from_numpy(logits), torch.from_numpy(tok), TEMP, TOP_K, 1.0)
    np.testing.assert_allclose(lp, again.numpy(), rtol=1e-6)
    want = np.asarray(ref.token_logprobs(jnp.asarray(logits), jnp.asarray(tok.astype(np.int32)), TEMP, TOP_K, 1.0))
    np.testing.assert_allclose(lp, want, rtol=1e-5, atol=1e-5)


def test_greedy_and_topk1_equal_argmax():
    logits = _logits(5, b=4)
    am = logits.argmax(-1).tolist()
    for temp, top_k, top_p in [(0.0, 0, 1.0), (1.0, 1, 1.0), (1.0, 0, 1e-6)]:
        for s in range(5):
            tok, _ = _sample(logits, np.full(4, s), np.arange(4), temp, top_k, top_p)
            assert tok.tolist() == am, (temp, top_k, top_p)


def test_topk_and_topp_restrict_support():
    logits = _logits(6, b=2, v=64)
    order = np.argsort(-logits, -1)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    sorted_p = np.take_along_axis(probs, order, -1)
    n_nucleus = ((np.cumsum(sorted_p, -1) - sorted_p) < 0.5).sum(-1)
    for i in range(30):
        tok, _ = _sample(logits, np.full(2, i), np.zeros(2), 1.0, top_k=5)
        for row in range(2):
            assert tok[row] in order[row, :5]
        tok, _ = _sample(logits, np.full(2, i), np.zeros(2), 1.0, top_p=0.5)
        for row in range(2):
            assert tok[row] in order[row, : n_nucleus[row]]


def test_seed_index_reproducible_across_slots_and_batches():
    """A request's token at output index i depends only on (seed, i) and
    its logits: moving it to another slot, batching it with other
    requests, or re-sampling after a preemption gives the same token."""
    row = _logits(7, b=1)[0]
    others = _logits(8, b=3)
    solo, _ = _sample(row[None], [42], [17], 1.5)
    batch = np.stack([others[0], others[1], row, others[2]])
    tok, _ = _sample(batch, [1, 2, 42, 3], [0, 5, 17, 9], 1.5)
    assert tok[2] == solo[0]
    tok2, _ = _sample(batch[::-1].copy(), [3, 42, 2, 1], [9, 17, 5, 0], 1.5)
    assert tok2[1] == solo[0]
    # a different index or seed draws afresh: over many indices the row is
    # not stuck on one token
    draws = {_sample(row[None], [42], [c], 1.5)[0][0] for c in range(40)}
    assert len(draws) > 3
    # negative seeds key like their uint32 mask (the engine masks them)
    assert port._mix64(-1, 3) == port._mix64(0xFFFFFFFF, 3)


def test_gumbel_noise_draws_only_sampled_rows():
    """Greedy rows (no generator) get zeros; a sampled row's noise depends
    only on its own generator, whatever the other rows are."""
    v = 50
    assert torch.equal(port.gumbel_noise([None, None], v, "cpu"), torch.zeros(2, v))
    solo = port.gumbel_noise([port.row_generator(42, 3)], v, "cpu")
    mixed = port.gumbel_noise([None, port.row_generator(42, 3), None, port.row_generator(7, 0)], v, "cpu")
    assert mixed.shape == (4, v) and mixed.dtype == torch.float32
    assert torch.equal(mixed[1], solo[0])
    assert torch.equal(mixed[0], torch.zeros(v)) and torch.equal(mixed[2], torch.zeros(v))
    assert torch.isfinite(mixed).all() and not torch.equal(mixed[3], mixed[1])


def test_sampled_frequencies_match_reference_distribution():
    """N draws at distinct output indices; each token's frequency must sit
    within 5 binomial standard deviations (+1e-3) of the reference's
    filtered-softmax probability, and masked tokens must never appear."""
    v, n = 12, 6000
    logits = np.random.RandomState(9).randn(1, v).astype(np.float32)
    knobs = (np.float32([0.8]), np.int32([6]), np.float32([0.95]))
    masked = ref._filtered_logits(jnp.asarray(logits), *map(jnp.asarray, knobs))
    p = np.asarray(jax.nn.softmax(masked, axis=-1))[0]
    tok, _ = _sample(np.repeat(logits, n, 0), np.full(n, 123), np.arange(n), 0.8, 6, 0.95)
    freq = np.bincount(tok, minlength=v) / n
    bound = 5 * np.sqrt(p * (1 - p) / n) + 1e-3
    assert np.all(np.abs(freq - p) <= bound), (freq, p)
    assert np.all(freq[p == 0] == 0)


# ---------------------------------------------------------------------------
# speculative verification
# ---------------------------------------------------------------------------


def _window_drafts(logits):
    """Drafts against the greedy chain: all right, one wrong at index 2,
    all wrong, and random."""
    s, w, v = logits.shape
    am = logits.argmax(-1)[:, : w - 1]
    draft = am.copy()
    draft[1, 2] = (am[1, 2] + 1) % v
    draft[2] = (am[2] + 1) % v
    draft[3] = np.random.RandomState(0).randint(0, v, w - 1)
    return draft.astype(np.int32)


def test_greedy_verify_matches_reference():
    logits = np.random.RandomState(10).randn(4, 5, 50).astype(np.float32)
    draft = _window_drafts(logits)
    noise = torch.zeros(4, 5, 50)
    n_acc, out, lp = port.speculative_verify_logprobs(
        torch.from_numpy(logits), torch.from_numpy(draft), noise, 0.0)
    for s in range(4):
        r_n, r_out, r_lp = ref.speculative_verify_logprobs(
            jnp.asarray(logits[s]), jnp.asarray(draft[s]), jnp.uint32(s), jnp.int32(3), 0.0)
        assert int(n_acc[s]) == int(r_n)
        assert out[s].tolist() == np.asarray(r_out).tolist()
        np.testing.assert_allclose(lp[s].numpy(), np.asarray(r_lp), atol=1e-5)
    assert n_acc.tolist() == [4, 2, 0, int(n_acc[3])]


def test_greedy_verify_ignores_the_seed():
    logits = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 10).astype(np.float32))
    gr = logits.argmax(-1)
    for seed in (0, 1, 2):
        noise = _window_noise([seed, seed + 7], [0, 4], [0.0, 0.0], 3, 10, "cpu")
        n, out = port.speculative_verify(logits, gr[:, :2], noise, temperature=0.0)
        assert n.tolist() == [2, 2] and torch.equal(out, gr)


def test_verify_index_draws_like_plain_sampling():
    """Window index i of a slot is the plain path's draw at output index
    counter + i: same generator, same filtered distribution, same
    logprob."""
    logits = np.random.RandomState(12).randn(3, 4, 40).astype(np.float32)
    seeds, counters = [5, 9, 2], [0, 7, 30]
    temp = np.float32([0.9, 1.3, 0.0])
    top_k = np.int64([0, 6, 0])
    top_p = np.float32([0.8, 1.0, 1.0])
    noise = _window_noise(seeds, counters, temp, 4, 40, "cpu")
    draft = torch.from_numpy(logits.argmax(-1)[:, :3])
    _, out, lp = port.speculative_verify_logprobs(
        torch.from_numpy(logits), draft, noise, torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p))
    for s in range(3):
        for i in range(4):
            tok, want = _sample(logits[s, i][None], [seeds[s]], [counters[s] + i], temp[s],
                                top_k[s], top_p[s])
            assert int(out[s, i]) == int(tok[0])
            np.testing.assert_allclose(float(lp[s, i]), float(want[0]), rtol=1e-6)


def test_verified_position_reproduces_target_distribution():
    """Port of the reference's test of the same name: sample-then-match
    must reproduce the target softmax in distribution whatever token was
    drafted — empirical frequencies of the first window token over 1500
    seeds against the analytic target. ~3 sigma of a binomial at n=1500 is
    ~0.04; the bias this guards against (accepting only on a match) is
    >> 0.1."""
    v, n = 16, 1500
    logits = np.random.RandomState(0).randn(2, v).astype(np.float32) * 1.5
    target = np.asarray(jax.nn.softmax(jnp.asarray(logits[0])))
    draft_tok = int(np.argmax(target))  # high-probability draft: mostly accepts
    seeds = np.arange(n)
    noise = _window_noise(seeds, np.zeros(n), np.ones(n), 2, v, "cpu")
    n_acc, out = port.speculative_verify(
        torch.from_numpy(np.repeat(logits[None], n, 0)),
        torch.full((n, 1), draft_tok), noise, temperature=1.0)
    emp = np.bincount(out[:, 0].numpy(), minlength=v) / n
    np.testing.assert_allclose(emp, target, atol=0.05)
    # acceptance tracks p(draft)
    assert abs(n_acc.float().mean().item() - target[draft_tok]) < 0.05
