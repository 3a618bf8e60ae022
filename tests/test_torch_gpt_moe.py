"""ray_tpu_torch.models.gpt's mixture of experts vs ray_tpu.models.gpt, on
the CPU, at vocab 256, seq 64, d 64, 2 layers, 2 heads, 4 experts, top-2.

The reference's ``gpt_init`` MoE tree is carried over with
``params_from_jax``; the same numpy tokens go through both. In fp32 the
logits and every gradient agree within 1e-5 absolute, the aux loss and
the loss within 1e-5 relative, under both of the port's dispatch forms
(``"index"`` and the reference's ``"einsum"``); bf16 within the stated
``BF16_*`` bounds. At capacity factor 0.25 assignments drop, and the port drops
the same ones (the reference's token-major cumsum order); a router that
ties every expert picks the lower experts first, as ``lax.top_k`` does. The
rest mirrors ``tests/test_moe.py`` (its expert-parallel test waits for the
port's ``ep`` mesh, ROADMAP.md A8)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt as ref
from ray_tpu_torch.models import gpt as port
from ray_tpu_torch.parallel import adamw, build_train_step

SHAPE = dict(vocab_size=256, seq_len=64, d_model=64, n_layers=2, n_heads=2, dtype="float32",
             n_experts=4, experts_per_token=2)
TOKENS = np.random.RandomState(5).randint(0, 256, (2, 65)).astype(np.int32)
#: bf16 activations: logits and loss within these of the reference's bf16 run
BF16_LOGITS_ATOL = 0.1
BF16_LOSS_RTOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads, and one ``torch.exp`` call before any
    comparison (ROADMAP.md §C.1: a process's first multi-threaded ``exp``
    can be off on this CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(torch.zeros(1024))
    yield
    torch.set_num_threads(before)


def _cfgs(**kw):
    kw = {**SHAPE, "remat": False, **kw}
    return ref.GPTConfig(**kw), port.GPTConfig(**kw)


@pytest.fixture(scope="module")
def tree():
    return jax.device_get(ref.gpt_init(jax.random.PRNGKey(0), _cfgs()[0]))


def _grad_tree(cfg, model):
    holder = port._empty_model(cfg, torch.device("cpu"))
    with torch.no_grad():
        for h, p in zip(holder.parameters(), model.parameters()):
            h.copy_(p.grad)
    return port.params_to_numpy(holder)


def _leaves(t):
    return jax.tree_util.tree_leaves_with_path(t)


def _reference(cfg, tree, tokens):
    loss, grads = jax.jit(jax.value_and_grad(lambda p: ref.gpt_loss(cfg, p, jnp.asarray(tokens))))(tree)
    logits, aux = jax.jit(lambda p: ref.gpt_forward(cfg, p, jnp.asarray(tokens[:, :-1]),
                                                    return_aux=True))(tree)
    return float(loss), jax.device_get(grads), np.asarray(logits), float(aux)


def _port(cfg, tree, tokens, dispatch):
    model = port.params_from_jax(tree, cfg, "cpu")
    loss = port.gpt_loss(cfg, model, torch.from_numpy(tokens), moe_dispatch=dispatch)
    loss.backward()
    with torch.no_grad():
        logits, aux = port.gpt_forward(cfg, model, torch.from_numpy(tokens[:, :-1]),
                                       return_aux=True, moe_dispatch=dispatch)
    return loss.item(), _grad_tree(cfg, model), logits.numpy(), aux.item()


def _assert_match(got, want):
    loss, grads, logits, aux = got
    want_loss, want_grads, want_logits, want_aux = want
    np.testing.assert_allclose(logits, want_logits, atol=1e-5)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert jax.tree_util.tree_structure(grads) == jax.tree_util.tree_structure(want_grads)
    for (path, a), (_, b) in zip(_leaves(grads), _leaves(want_grads)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def reference(tree):
    """The reference's (loss, grads, logits, aux) per config change."""
    cache = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            cache[key] = _reference(_cfgs(**kw)[0], tree, TOKENS)
        return cache[key]

    return get


@pytest.mark.parametrize("dispatch", port.MOE_DISPATCH)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_fp32_logits_aux_loss_and_grads_match_reference(tree, reference, dispatch, capacity_factor):
    _, cfg = _cfgs(capacity_factor=capacity_factor)
    _assert_match(_port(cfg, tree, TOKENS, dispatch), reference(capacity_factor=capacity_factor))


@pytest.mark.parametrize("dispatch", port.MOE_DISPATCH)
def test_bf16_matches_reference(tree, reference, dispatch):
    _, cfg = _cfgs(dtype="bfloat16")
    want = reference(dtype="bfloat16")
    loss, _, logits, aux = _port(cfg, tree, TOKENS, dispatch)
    np.testing.assert_allclose(logits, want[2], atol=BF16_LOGITS_ATOL)
    np.testing.assert_allclose(loss, want[0], rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(aux, want[3], rtol=BF16_LOSS_RTOL)


def _layer0_input(tree, cfg):
    """The first block's MLP input (ln2 of the post-attention residual) and
    layer 0's parameters, as numpy, from the reference's functions."""
    layer = jax.tree_util.tree_map(lambda a: a[0], tree["blocks"])
    x = tree["embed"]["tokens"][TOKENS[:, :-1]] + tree["embed"]["pos"][:64]
    ln1 = ref._layernorm(jnp.asarray(x), layer["ln1"]["scale"], layer["ln1"]["bias"])
    qkv = ln1 @ layer["attn_qkv"]["kernel"] + layer["attn_qkv"]["bias"]
    q, k, v = (t.reshape(2, 64, 2, 32).transpose(0, 2, 1, 3) for t in jnp.split(qkv, 3, axis=-1))
    att = ref.causal_attention(q, k, v, impl="xla").transpose(0, 2, 1, 3).reshape(2, 64, 64)
    x = x + att @ layer["attn_out"]["kernel"] + layer["attn_out"]["bias"]
    return np.array(ref._layernorm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])), layer


def _reference_keep(cfg, flat, router):
    """The reference's routing lines (``ray_tpu/models/gpt.py:137-152``):
    which assignments, token-major, it keeps."""
    n, E, k = flat.shape[0], cfg.n_experts, cfg.experts_per_token
    cap = max(1, int(cfg.capacity_factor * k * n / E))
    probs = jax.nn.softmax(jnp.asarray(flat) @ router, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(gate_idx.reshape(n * k), E, dtype=jnp.float32)
    pos = ((jnp.cumsum(onehot, axis=0) - 1.0) * onehot).sum(-1)
    return np.asarray(gate_idx).reshape(n * k), np.asarray(pos < cap)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_dropped_assignments_are_the_references(tree, capacity_factor):
    ref_cfg, cfg = _cfgs(capacity_factor=capacity_factor)
    h, layer = _layer0_input(tree, ref_cfg)
    want_expert, want_keep = _reference_keep(ref_cfg, h.reshape(-1, 64), layer["router"]["kernel"])
    model = port.params_from_jax(tree, cfg, "cpu")
    with torch.no_grad():
        _, expert, _, keep, _ = port._moe_route(cfg, torch.from_numpy(h.reshape(-1, 64)),
                                                model.blocks[0].router)
    np.testing.assert_array_equal(expert.numpy(), want_expert)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if capacity_factor < 1:
        assert 0 < (~want_keep).sum() < want_keep.size  # some drop, not all
    want_out, want_aux = ref._moe_mlp(ref_cfg, jnp.asarray(h), layer, lambda y, spec: y)
    for dispatch in port.MOE_DISPATCH:
        with torch.no_grad():
            out, aux = port._moe_mlp(cfg, torch.from_numpy(h), model.blocks[0], dispatch)
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5)
        np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)


def test_router_ties_pick_the_lower_experts_first(tree):
    """A zero router gives every expert one probability: both packages route
    every token to experts 0 and 1, in that order, and drop the same
    overflow; loss and gradients still match."""
    tied = jax.tree_util.tree_map(np.array, tree)
    tied["blocks"]["router"]["kernel"][:] = 0.0
    ref_cfg, cfg = _cfgs()
    h, layer = _layer0_input(tied, ref_cfg)
    want_expert, want_keep = _reference_keep(ref_cfg, h.reshape(-1, 64), layer["router"]["kernel"])
    assert (want_expert.reshape(-1, 2) == [0, 1]).all()
    model = port.params_from_jax(tied, cfg, "cpu")
    with torch.no_grad():
        _, expert, _, keep, _ = port._moe_route(cfg, torch.from_numpy(h.reshape(-1, 64)),
                                                model.blocks[0].router)
    np.testing.assert_array_equal(expert.numpy(), want_expert)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    _assert_match(_port(cfg, tied, TOKENS, "index"), _reference(ref_cfg, tied, TOKENS))


def test_moe_tree_round_trips_exactly(tree):
    _, cfg = _cfgs()
    model = port.params_from_jax(tree, cfg, "cpu")
    blk = model.blocks[1]
    assert not hasattr(blk, "mlp_in")
    assert tuple(blk.router.shape) == (64, 4) and tuple(blk.moe_in.shape) == (4, 64, 256)
    assert tuple(blk.moe_out.shape) == (4, 256, 64)
    np.testing.assert_array_equal(blk.moe_in.detach().numpy(), tree["blocks"]["moe_in"]["kernel"][1])
    back = port.params_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for (path, a), (_, b) in zip(_leaves(back), _leaves(tree)):
        assert a.dtype == np.float32 and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def test_gpt_decode_refuses_moe(tree):
    _, cfg = _cfgs()
    model = port.params_from_jax(tree, cfg, "cpu")
    with pytest.raises(NotImplementedError, match="dense"):
        port.gpt_decode(cfg, model, torch.zeros(1, 4, dtype=torch.long), 2)


# mirrors of tests/test_moe.py


def test_moe_forward_shapes_and_aux():
    _, cfg = _cfgs()
    model = port.gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    blocks = port.params_to_numpy(model)["blocks"]
    assert "moe_in" in blocks and "router" in blocks
    assert blocks["moe_in"]["kernel"].shape == (2, 4, 64, 256)
    tokens = torch.randint(0, 256, (2, 64), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, aux = port.gpt_forward(cfg, model, tokens, return_aux=True)
    assert logits.shape == (2, 64, 256)
    # balanced-ish routing at init: aux near k (its value under uniform routing)
    assert 0.5 < aux.item() < 6.0


def test_moe_capacity_drops_dont_nan():
    _, cfg = _cfgs(capacity_factor=0.5)  # force heavy dropping
    model = port.gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, 256, (2, 64), generator=torch.Generator().manual_seed(1))
    loss = port.gpt_loss(cfg, model, tokens)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_moe_trains_loss_decreases():
    _, cfg = _cfgs()
    init_fn, step_fn = build_train_step(lambda p, t: port.gpt_loss(cfg, p, t), adamw(1e-3))
    state = init_fn(port.gpt_init(cfg, torch.Generator().manual_seed(0), "cpu"), "cpu")
    tokens = torch.randint(0, 256, (4, 65), generator=torch.Generator().manual_seed(1))
    state, l0 = step_fn(state, tokens)
    for _ in range(5):
        state, loss = step_fn(state, tokens)
    assert float(loss) < float(l0), (float(l0), float(loss))


def test_dense_config_unchanged():
    _, cfg = _cfgs(n_experts=0)
    model = port.gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    blocks = port.params_to_numpy(model)["blocks"]
    assert "mlp_in" in blocks and "router" not in blocks
    tokens = torch.randint(0, 256, (2, 65), generator=torch.Generator().manual_seed(1))
    loss = port.gpt_loss(cfg, model, tokens)
    assert torch.isfinite(loss)
    assert port.gpt_hidden(cfg, model, tokens[:, :-1])[1].item() == 0.0
