"""ray_tpu_torch.parallel.train_step vs ray_tpu.parallel.train_step, on the CPU.

Three AdamW steps (lr 1e-3, optax's defaults) of the port's
``build_train_step`` against the reference's ``build_train_step(loss_fn,
optax.adamw(1e-3), mesh)`` on a one-device mesh, built as ``bench.py``
builds it, from the same fp32 weights and the same numpy tokens. Losses
agree within 1e-5 relative at every step and every parameter within 1e-4
absolute after the last, with one exception. The key slice of the qkv bias
has a gradient that is exactly zero in exact arithmetic (adding one vector
to every key adds one constant to a query's scores, which the softmax
ignores), so both frameworks compute rounding noise there (~1e-9).
AdamW's normalised update turns that noise into steps of up to lr whose
sign the rounding picks, so those 2 x d_model x n_layers elements are held
within 2 x lr x steps instead, and a separate test pins their gradient at
rounding level. Rows of the embeddings that the batch never touches have
exactly zero gradients on both sides and move by the weight decay only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ray_tpu.models import gpt as ref
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.parallel.train_step import build_train_step as ref_build_train_step
from ray_tpu_torch.models import gpt as port
from ray_tpu_torch.parallel import TrainState, adamw, build_train_step

SHAPE = dict(vocab_size=512, seq_len=32, d_model=128, n_layers=2, n_heads=2, dtype="float32")
STEPS = 3
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    other files' runtime tests time their worker start-ups."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batches():
    rng = np.random.RandomState(11)
    return [rng.randint(0, SHAPE["vocab_size"], (4, SHAPE["seq_len"] + 1)).astype(np.int32)
            for _ in range(STEPS)]


@pytest.fixture(scope="module", params=["full", "attn"])
def runs(request):
    """(reference losses, reference params, port losses, port state) after
    STEPS steps under one remat policy."""
    policy = request.param
    cfg_ref = ref.GPTConfig(**SHAPE, remat_policy=policy)
    cfg = port.GPTConfig(**SHAPE, remat_policy=policy)
    params = ref.gpt_init(jax.random.PRNGKey(0), cfg_ref)
    tree = jax.device_get(params)
    batches = _batches()

    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1), devices=[jax.devices()[0]])
    init_ref, step_ref = ref_build_train_step(
        lambda p, t: ref.gpt_loss(cfg_ref, p, t, mesh), optax.adamw(LR), mesh)
    state = init_ref(params)
    ref_losses = []
    for b in batches:
        state, loss = step_ref(state, jnp.asarray(b))
        ref_losses.append(float(loss))
    ref_params = jax.device_get(state.params)

    init_fn, step_fn = build_train_step(lambda p, t: port.gpt_loss(cfg, p, t), adamw(LR))
    pstate = init_fn(port.params_from_jax(tree, cfg, "cpu"), "cpu")
    port_losses = []
    for b in batches:
        pstate, loss = step_fn(pstate, torch.from_numpy(b))
        port_losses.append(loss.item())
    return ref_losses, ref_params, port_losses, pstate


def test_losses_match_at_every_step(runs):
    ref_losses, _, port_losses, _ = runs
    np.testing.assert_allclose(port_losses, ref_losses, rtol=1e-5)


def test_params_match_after_the_last_step(runs):
    _, ref_params, _, state = runs
    assert isinstance(state, TrainState) and state.step == STEPS
    got = port.params_to_numpy(state.params)
    d = SHAPE["d_model"]
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(ref_params)):
        name = jax.tree_util.keystr(path)
        if name == "['blocks']['attn_qkv']['bias']":
            key = slice(d, 2 * d)
            np.testing.assert_allclose(a[:, key], b[:, key], atol=2 * LR * STEPS, rtol=0, err_msg=name)
            a, b = np.delete(a, np.s_[d:2 * d], axis=1), np.delete(b, np.s_[d:2 * d], axis=1)
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=name)


def test_key_bias_gradient_is_rounding_noise():
    """Why the key bias is exempt above: its gradient is ~1e-9 while the
    query and value biases' are ~1e-2."""
    cfg = port.GPTConfig(**SHAPE)
    model = port.gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    port.gpt_loss(cfg, model, torch.from_numpy(_batches()[0])).backward()
    d = SHAPE["d_model"]
    for blk in model.blocks:
        g = blk.attn_qkv.bias.grad
        assert g[d:2 * d].abs().max() < 1e-7
        assert g[:d].abs().max() > 1e-4 and g[2 * d:].abs().max() > 1e-4


def test_adamw_has_optax_defaults():
    opt = adamw(1e-4)([torch.nn.Parameter(torch.zeros(2))])
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW)
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (1e-4, (0.9, 0.999), 1e-8, 1e-4)


def test_step_updates_fp32_params_in_place():
    cfg = port.GPTConfig(**dict(SHAPE, dtype="bfloat16"), remat_policy="attn")
    init_fn, step_fn = build_train_step(lambda p, t: port.gpt_loss(cfg, p, t), adamw(LR))
    state = init_fn(port.gpt_init(cfg, torch.Generator().manual_seed(0), "cpu"), "cpu")
    before = state.params.blocks[0].attn_qkv.weight.detach().clone()
    weight = state.params.blocks[0].attn_qkv.weight
    state, loss = step_fn(state, torch.from_numpy(_batches()[0]))
    assert state.step == 1 and torch.isfinite(loss) and loss.dtype == torch.float32
    assert state.params.blocks[0].attn_qkv.weight is weight  # updated in place
    assert weight.dtype == torch.float32 and weight.grad.dtype == torch.float32
    assert not torch.equal(weight.detach(), before)
    assert all(s["exp_avg"].dtype == torch.float32 for s in state.opt_state.state.values())

