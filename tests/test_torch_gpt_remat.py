"""Rematerialization policies of the port's GPT and GPT-J vs the
reference's, on the CPU.

Every policy gives the gradients the reference gives under the same policy
(fp32, within 1e-5 absolute): GPT
under ``"full"``, ``"dots"``, ``"attn"``, ``"attn_qkv"`` and ``"big"``,
dense and mixture-of-experts, GPT-J under ``"full"``, ``"dots"`` and
``"attn"``. The port's attention is the flash op's plain path, counted by
wrapping ``flash_fwd_reference``: per layer and step the forward runs twice
under ``"full"`` and ``"dots"`` (the backward recomputes it) and once under
the others (they keep its out and lse), as JAX recomputes it under each.
What else a policy keeps shows in the backward's recomputed projections
(``addmm``, the biased linears): under ``"full"``, ``"attn"`` and ``"big"``
three of a block's four (qkv, out and mlp_in; the recompute stops before
mlp_out, whose output the backward never reads, as JAX's leaves it out),
two under ``"attn_qkv"`` (the qkv projection is kept), none under
``"dots"``."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as ref
from ray_tpu.models import gptj as ref_gptj
from ray_tpu_torch.models import gpt as port
from ray_tpu_torch.models import gptj as port_gptj
from ray_tpu_torch.ops import flash_attention as fa

SHAPE = dict(vocab_size=256, seq_len=64, d_model=64, n_layers=2, n_heads=2, dtype="float32")
GPTJ_SHAPE = dict(vocab_size=128, seq_len=32, d_model=64, n_layers=2, n_heads=2, rotary_dim=8,
                  dtype="float32")
TOKENS = np.random.RandomState(9).randint(0, 128, (2, 33)).astype(np.int32)
POLICIES = ("full", "dots", "attn", "attn_qkv", "big")
#: flash forwards per layer and step, by policy
FORWARDS = {"full": 2, "dots": 2, "attn": 1, "attn_qkv": 1, "big": 1}
#: biased projections the backward recomputes per dense GPT layer, by policy
RECOMPUTED_LINEARS = {"full": 3, "dots": 0, "attn": 3, "attn_qkv": 2, "big": 3}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads, and one ``torch.exp`` call before any
    comparison (ROADMAP.md §C.1)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(1024))
    yield
    torch.set_num_threads(before)


@pytest.fixture
def flash_forwards(monkeypatch):
    """How many times the flash op's plain forward runs."""
    count = [0]
    plain = fa.flash_fwd_reference

    def counted(q, k, v):
        count[0] += 1
        return plain(q, k, v)

    monkeypatch.setattr(fa, "flash_fwd_reference", counted)
    return count


class _CountAddmm(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.addmm.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _grad_tree(cfg, model):
    """The GPT's .grad in the reference's tree layout."""
    holder = port._empty_model(cfg, torch.device("cpu"))
    with torch.no_grad():
        for h, p in zip(holder.parameters(), model.parameters()):
            h.copy_(p.grad)
    return port.params_to_numpy(holder)


def _assert_grads(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def gpt_trees():
    return {e: jax.device_get(ref.gpt_init(jax.random.PRNGKey(0), ref.GPTConfig(**SHAPE, n_experts=e)))
            for e in (0, 4)}


@pytest.mark.parametrize("n_experts", [0, 4])
@pytest.mark.parametrize("policy", POLICIES)
def test_gpt_policy_grads_match_reference(gpt_trees, flash_forwards, policy, n_experts):
    tree = gpt_trees[n_experts]
    ref_cfg = ref.GPTConfig(**SHAPE, n_experts=n_experts, remat=True, remat_policy=policy)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: ref.gpt_loss(ref_cfg, p, jnp.asarray(TOKENS))))(tree)
    cfg = port.GPTConfig(**SHAPE, n_experts=n_experts, remat=True, remat_policy=policy,
                         attn_impl="flash")
    model = port.params_from_jax(tree, cfg, "cpu")
    loss = port.gpt_loss(cfg, model, torch.from_numpy(TOKENS))
    assert flash_forwards[0] == cfg.n_layers
    loss.backward()
    assert flash_forwards[0] == FORWARDS[policy] * cfg.n_layers
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_grads(_grad_tree(cfg, model), jax.device_get(want))


@pytest.mark.parametrize("policy", POLICIES)
def test_gpt_policy_keeps_what_it_names(gpt_trees, policy):
    """The backward's recomputed biased projections show what each policy
    keeps; the loss and gradients equal the unrematerialized run's."""
    tree = gpt_trees[0]
    runs = {}
    for remat in (False, True):
        cfg = port.GPTConfig(**SHAPE, remat=remat, remat_policy=policy, attn_impl="flash")
        model = port.params_from_jax(tree, cfg, "cpu")
        loss = port.gpt_loss(cfg, model, torch.from_numpy(TOKENS))
        with _CountAddmm() as count:
            loss.backward()
        runs[remat] = (loss.item(), [p.grad for p in model.parameters()], count.n)
    assert runs[False][2] == 0
    assert runs[True][2] == RECOMPUTED_LINEARS[policy] * SHAPE["n_layers"]
    assert runs[True][0] == runs[False][0]
    for a, b in zip(runs[True][1], runs[False][1]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_gpt_attn_policy_on_the_einsum_keeps_nothing(gpt_trees):
    """On the einsum attention no flash op runs: ``"attn"`` recomputes the
    whole block, as the reference's degrades to full remat there."""
    cfg = port.GPTConfig(**SHAPE, remat=True, remat_policy="attn", attn_impl="xla")
    model = port.params_from_jax(gpt_trees[0], cfg, "cpu")
    loss = port.gpt_loss(cfg, model, torch.from_numpy(TOKENS))
    with _CountAddmm() as count:
        loss.backward()
    assert count.n == RECOMPUTED_LINEARS["full"] * SHAPE["n_layers"]


@pytest.fixture(scope="module")
def gptj_tree():
    cfg = ref_gptj.GPTJConfig(**GPTJ_SHAPE)
    return jax.device_get(ref_gptj.gptj_init(jax.random.PRNGKey(1), cfg))


@pytest.mark.parametrize("policy", ["full", "attn", "dots"])
def test_gptj_policy_grads_match_reference(gptj_tree, flash_forwards, policy):
    ref_cfg = ref_gptj.GPTJConfig(**GPTJ_SHAPE, remat=True, remat_policy=policy)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: ref_gptj.gptj_loss(ref_cfg, p, jnp.asarray(TOKENS))))(gptj_tree)
    cfg = port_gptj.GPTJConfig(**GPTJ_SHAPE, remat=True, remat_policy=policy, attn_impl="flash")
    model = port_gptj.params_from_jax(gptj_tree, cfg, "cpu").requires_grad_(True)
    loss = port_gptj.gptj_loss(cfg, model, torch.from_numpy(TOKENS))
    loss.backward()
    assert flash_forwards[0] == FORWARDS[policy] * cfg.n_layers
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = jax.device_get(want)
    blocks = want["blocks"]
    pairs = [
        (model.lm_head.bias.grad, want["lm_head"]["bias"]),
        (model.lm_head.weight.grad.T, want["lm_head"]["kernel"]),
        (model.embed.weight.grad, want["embed"]["tokens"]),
        (model.ln_f.scale.grad, want["ln_f"]["scale"]),
    ]
    for i, blk in enumerate(model.blocks):
        pairs += [(getattr(blk, name).weight.grad.T, blocks[name]["kernel"][i])
                  for name in ("q", "k", "v", "attn_out", "mlp_in", "mlp_out")]
        pairs += [(blk.ln1.scale.grad, blocks["ln1"]["scale"][i]),
                  (blk.mlp_in.bias.grad, blocks["mlp_in"]["bias"][i])]
    for got, w in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("module,cfg", [
    (port, port.GPTConfig(**SHAPE, remat=True, remat_policy="nope")),
    (port_gptj, port_gptj.GPTJConfig(**GPTJ_SHAPE, remat=True, remat_policy="attn_qkv")),
])
def test_unknown_policies_raise(module, cfg):
    """A policy the reference does not have for the model raises, naming
    the ones it has (GPT-J's are "full", "dots" and "attn")."""
    tokens = torch.from_numpy(TOKENS[:, :17].astype(np.int64))
    init = port.gpt_init if module is port else port_gptj.gptj_init
    if module is port:
        with pytest.raises(ValueError, match="remat_policy"):
            init(cfg, torch.Generator(), "cpu")
        model = port.gpt_init(dataclasses.replace(cfg, remat_policy="full"), torch.Generator(), "cpu")
        with pytest.raises(ValueError, match="remat_policy"):
            port.gpt_loss(cfg, model, tokens)
    else:
        model = init(cfg, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match="remat_policy"):
            port_gptj.gptj_loss(cfg, model, tokens)
