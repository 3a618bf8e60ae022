"""ray_tpu_torch.models.gpt vs ray_tpu.models.gpt, on the CPU.

The reference's ``gpt_init(PRNGKey(0), TINY)`` fp32 weights are carried over
with ``params_from_jax``; the same numpy tokens go through both forwards
(logits within 1e-4), both losses (1e-5 relative) and both gradients (1e-5
absolute plus 1e-4 relative: the frameworks sum matmuls in different
orders), with the einsum and the flash attention paths (the reference's
Pallas kernels in interpret mode, the port's plain flash functions) and
with and without the fused loss. Rematerialization, under each of the five
policies, must not change the loss or the gradients.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as ref
from ray_tpu_torch.models import gpt as port

SHAPE = dict(vocab_size=256, seq_len=32, d_model=128, n_layers=2, n_heads=2, dtype="float32")
TINY_REF = ref.GPTConfig(**SHAPE, remat=False)
TINY = port.GPTConfig(**SHAPE, remat=False)
TOKENS = np.random.RandomState(7).randint(0, 256, (2, 33)).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    other files' runtime tests time their worker start-ups."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tree():
    return jax.device_get(ref.gpt_init(jax.random.PRNGKey(0), TINY_REF))


@pytest.fixture(scope="module")
def reference(tree):
    """Loss and gradient trees of the reference, per (attn_impl, fused_loss)."""
    cache = {}

    def get(attn_impl, fused_loss):
        key = (attn_impl, fused_loss)
        if key not in cache:
            cfg = dataclasses.replace(TINY_REF, attn_impl=attn_impl, fused_loss=fused_loss)
            loss, grads = jax.value_and_grad(lambda p: ref.gpt_loss(cfg, p, jnp.asarray(TOKENS)))(tree)
            cache[key] = (float(loss), jax.device_get(grads))
        return cache[key]

    return get


def _grad_tree(cfg, model):
    """The model's .grad in the reference's tree layout."""
    holder = port._empty_model(cfg, torch.device("cpu"))
    with torch.no_grad():
        for h, p in zip(holder.parameters(), model.parameters()):
            h.copy_(p.grad)
    return port.params_to_numpy(holder)


def _leaves(t):
    return jax.tree_util.tree_leaves_with_path(t)


def test_params_round_trip_exactly(tree):
    model = port.params_from_jax(tree, TINY, "cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())
    np.testing.assert_array_equal(
        model.blocks[1].attn_qkv.weight.detach().numpy(), tree["blocks"]["attn_qkv"]["kernel"][1].T)
    back = port.params_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for (path, a), (_, b) in zip(_leaves(back), _leaves(tree)):
        assert a.dtype == np.float32 and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def test_forward_matches_reference(tree):
    model = port.params_from_jax(tree, TINY, "cpu")
    want = np.asarray(ref.gpt_forward(TINY_REF, tree, jnp.asarray(TOKENS[:, :-1])))
    with torch.no_grad():
        got = port.gpt_forward(TINY, model, torch.from_numpy(TOKENS[:, :-1]))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("fused_loss", [True, False])
def test_loss_and_grads_match_reference(tree, reference, attn_impl, fused_loss):
    want_loss, want_grads = reference(attn_impl, fused_loss)
    cfg = dataclasses.replace(TINY, attn_impl=attn_impl, fused_loss=fused_loss)
    model = port.params_from_jax(tree, cfg, "cpu")
    loss = port.gpt_loss(cfg, model, torch.from_numpy(TOKENS))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    got = _grad_tree(cfg, model)
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want_grads)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("policy", ["full", "dots", "attn", "attn_qkv", "big"])
def test_remat_equals_no_remat(tree, policy):
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(TINY, attn_impl="flash", remat=remat, remat_policy=policy)
        model = port.params_from_jax(tree, cfg, "cpu")
        loss = port.gpt_loss(cfg, model, torch.from_numpy(TOKENS))
        loss.backward()
        results.append((loss.item(), [p.grad.clone() for p in model.parameters()]))
    (l0, g0), (l1, g1) = results
    assert l0 == l1
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_bf16_activations_keep_fp32_master_weights():
    cfg = dataclasses.replace(TINY, dtype="bfloat16", remat=True, remat_policy="attn")
    model = port.gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    again = port.gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)  # seeded: reproducible
    std = model.blocks[0].mlp_out.weight.std().item()
    assert abs(std - cfg.d_ff**-0.5) < 0.2 * cfg.d_ff**-0.5
    hidden, aux = port.gpt_hidden(cfg, model, torch.from_numpy(TOKENS[:, :-1]))
    assert hidden.dtype == torch.bfloat16 and hidden.shape == (*TOKENS[:, :-1].shape, cfg.d_model)
    assert aux.dtype == torch.float32 and aux.item() == 0.0  # dense: no MoE aux loss
    loss = port.gpt_loss(cfg, model, torch.from_numpy(TOKENS))
    loss.backward()
    assert torch.isfinite(loss)
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("change,match,at_init", [
    # the reference's message (ray_tpu/models/gpt.py:206-211): ring
    # attention needs a mesh, which a config alone does not say
    (dict(attn_impl="ring"), "needs a device mesh with an 'sp' axis", False),
    (dict(remat=True, remat_policy="nope"), "remat_policy", True),
])
def test_unported_configurations_raise(tree, change, match, at_init):
    cfg = dataclasses.replace(TINY, **change)
    if at_init:
        with pytest.raises(ValueError, match=match):
            port.gpt_init(cfg, torch.Generator(), "cpu")
    else:
        port.gpt_init(cfg, torch.Generator(), "cpu")
    model = port.params_from_jax(tree, TINY, "cpu")
    with pytest.raises(ValueError, match=match):
        port.gpt_loss(cfg, model, torch.from_numpy(TOKENS))
