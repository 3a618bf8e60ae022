"""ray_tpu_torch.parallel (mesh, sharding rules, the sharded train step,
global_put, mesh_allreduce) against the reference, on the CPU — a mirror of
``tests/test_model_parallel.py``.

The port's ranks are gloo processes (``tests/torch_ranks.py``): one spawn of
8 ranks computes every multi-rank case, the reference runs on its 8-device
virtual CPU mesh in this process, and both start from the reference's
``gpt_init`` weights (``params_from_jax``) and one numpy batch. Tolerances:
fp32 losses within 1e-5 relative; parameters after one SGD step within
1e-5 of the largest |value| (the port averages its batch slices' means,
the reference takes one mean over the global batch: equal to fp32
rounding, and a tp rank sums its partial products in another order).
Meshes of one rank run in this process under a fake process group, which
each test destroys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.models.gpt import gpt_init as ref_gpt_init
from ray_tpu.models.gpt import gpt_loss as ref_gpt_loss
from ray_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from ray_tpu.parallel.mesh import make_mesh as ref_make_mesh
from ray_tpu.parallel.sharding import batch_spec as ref_batch_spec
from ray_tpu.parallel.train_step import build_train_step as ref_build_train_step
from ray_tpu_torch.collective import ReduceOp
from ray_tpu_torch.models.gpt import GPTConfig, gpt_forward, params_from_jax
from ray_tpu_torch.parallel import MeshConfig, make_mesh, param_sharding_rules
from ray_tpu_torch.parallel.mesh import axis_size
from ray_tpu_torch.parallel.sharding import placements
from torch_ranks import run_ranks

TINY_FIELDS = dict(vocab_size=256, seq_len=64, d_model=64, n_layers=2, n_heads=4, dtype="float32")
TINY = GPTConfig(**TINY_FIELDS)
REF_TINY = RefGPTConfig(**TINY_FIELDS)
MESHES = {"dp": dict(dp=8, fsdp=1, tp=1), "3d": dict(dp=2, fsdp=2, tp=2), "fsdp_tp": dict(dp=1, fsdp=4, tp=2)}
ADAM_STEPS = 5
ALLREDUCE_SEED = 7
RTOL = 1e-5


def _batch() -> np.ndarray:
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, TINY.seq_len + 1), 0, 256, jnp.int32))


def _ref_tree() -> dict:
    return jax.tree_util.tree_map(np.asarray, jax.device_get(ref_gpt_init(jax.random.PRNGKey(0), REF_TINY)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    payload = dict(cfg=TINY_FIELDS, tree=_ref_tree(), batch=_batch().astype(np.int64), meshes=MESHES,
                   adam_steps=ADAM_STEPS, allreduce_seed=ALLREDUCE_SEED)
    return run_ranks(8, "parallel_modes", payload, tmp_path_factory.mktemp("parallel_modes"))


def _ref_step(axes, optimizer, steps=1):
    """The reference's step on its 8-device mesh: (losses, state)."""
    from jax.sharding import NamedSharding

    mesh = ref_make_mesh(RefMeshConfig(sp=1, **axes), devices=jax.devices("cpu")[:8])

    def loss_fn(params, batch):
        return ref_gpt_loss(REF_TINY, params, batch, mesh)

    init_fn, step_fn = ref_build_train_step(loss_fn, optimizer, mesh)
    state = init_fn(ref_gpt_init(jax.random.PRNGKey(0), REF_TINY))
    batch = jax.device_put(jnp.asarray(_batch()), NamedSharding(mesh, ref_batch_spec()))
    losses = []
    for _ in range(steps):
        state, loss = step_fn(state, batch)
        losses.append(float(loss))
    return losses, state


@pytest.fixture
def fake_group():
    """A fake process group of 8 ranks (this process is rank 0), destroyed
    after the test: DeviceMesh construction without processes."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_factoring(fake_group):
    m = make_mesh(MeshConfig(dp=-1, fsdp=2, tp=2), devices="cpu")
    assert {a: axis_size(m, a) for a in m.mesh_dim_names} == {"dp": 2, "fsdp": 2, "ep": 1, "tp": 2, "sp": 1}
    assert m.mesh.flatten().tolist() == list(range(8))  # tp innermost, dp outermost
    with pytest.raises(ValueError):
        MeshConfig(dp=3, fsdp=1, tp=1).resolve(8)
    with pytest.raises(ValueError):
        MeshConfig(dp=-1, fsdp=-1).resolve(8)


def test_forward_shapes():
    from ray_tpu_torch.models.gpt import gpt_init

    params = gpt_init(TINY, torch.Generator().manual_seed(0), device="cpu")
    logits = gpt_forward(TINY, params, torch.zeros(2, TINY.seq_len, dtype=torch.long))
    assert logits.shape == (2, TINY.seq_len, TINY.vocab_size)
    assert logits.dtype == torch.float32


def test_causality():
    params = params_from_jax(_ref_tree(), TINY, "cpu")
    t1 = torch.from_numpy(_batch()[:1, :-1]).long()
    t2 = t1.clone()
    t2[0, -1] = (t2[0, -1] + 1) % 256
    l1, l2 = gpt_forward(TINY, params, t1), gpt_forward(TINY, params, t2)
    torch.testing.assert_close(l1[0, :-1], l2[0, :-1], atol=1e-5, rtol=0)
    assert not torch.allclose(l1[0, -1], l2[0, -1])


def test_sharding_rules_cover_all_params(fake_group):
    # every spec must be rank-compatible with its parameter, and the rule
    # table's placements are the reference's with the Linear dims swapped
    from ray_tpu.parallel.sharding import spec_for_path as ref_spec

    params = params_from_jax(_ref_tree(), TINY, "cpu")
    specs = param_sharding_rules(params)
    assert set(specs) == {n for n, _ in params.named_parameters()}
    for name, p in params.named_parameters():
        assert len(specs[name]) <= p.dim(), (name, specs[name], p.shape)
    ref = {"blocks.0.attn_qkv.weight": "blocks/attn_qkv/kernel", "blocks.1.mlp_out.weight": "blocks/mlp_out/kernel",
           "embed.weight": "embed/tokens", "lm_head.weight": "lm_head/kernel", "blocks.0.ln1.scale": "blocks/ln1/scale"}
    for port_path, ref_path in ref.items():
        want = tuple(ref_spec(ref_path))
        want = want[1:] if ref_path.startswith("blocks/") else want  # the reference's stacked L dim
        if port_path.endswith(".weight") and port_path != "embed.weight":
            want = want[::-1]  # nn.Linear stores (out, in)
        assert specs[port_path] == want, (port_path, specs[port_path], want)
    mesh = make_mesh(MeshConfig(dp=2, fsdp=2, tp=2), devices="cpu")
    assert [str(p) for p in placements(specs["blocks.0.attn_qkv.weight"], mesh)] == [
        "R", "S(1)", "R", "R", "S(0)"]


class _AdamWSubclass(torch.optim.AdamW):
    """A subclass may override ``step``: the mesh step does not trust it."""


NON_ELEMENTWISE = {"Adafactor": torch.optim.Adafactor, "LBFGS": torch.optim.LBFGS,
                   "_AdamWSubclass": _AdamWSubclass}


@pytest.mark.parametrize("name", sorted(NON_ELEMENTWISE))
def test_a_non_elementwise_optimizer_is_refused(fake_group, name):
    """The sharded step updates each rank's shards on their own, the whole
    tensor's update only for an elementwise optimizer: Adafactor's row and
    column moments or LBFGS's line search would get a per-shard update. The
    step refuses them at init, and before it touches a parameter."""
    from ray_tpu_torch.models.gpt import gpt_loss
    from ray_tpu_torch.parallel import build_train_step
    from ray_tpu_torch.parallel.train_step import step_on_shards

    mesh = make_mesh(MeshConfig(dp=1, fsdp=-1), devices="cpu")
    init_fn, _ = build_train_step(lambda p, t: gpt_loss(TINY, p, t, mesh), NON_ELEMENTWISE[name], mesh)
    with pytest.raises(TypeError, match=f"{name} cannot run on a mesh"):
        init_fn(params_from_jax(_ref_tree(), TINY, "cpu"))
    w = torch.nn.Parameter(torch.zeros(4, 4))
    w.grad = torch.ones(4, 4)
    with pytest.raises(TypeError, match=f"{name} cannot run on a mesh"):
        step_on_shards(NON_ELEMENTWISE[name]([w]))
    assert not w.detach().any()


def test_parallelism_modes_agree(ranks):
    # dp-only vs dp×fsdp×tp must produce (numerically close) identical
    # steps, and each the reference's for the same mesh
    ref = {name: _ref_step(MESHES[name], optax.sgd(0.1)) for name in ("dp", "3d")}
    for name in ("dp", "3d"):
        losses = [r[name]["loss"] for r in ranks]
        assert len(set(losses)) == 1, (name, losses)  # the same global mean on every rank
        want = ref[name][0][0]
        assert abs(losses[0] - want) <= RTOL * abs(want), (name, losses[0], want)
        want_params = jax.tree_util.tree_map(np.asarray, jax.device_get(ref[name][1].params))
        for path, got in _leaves(ranks[0][name]["params"]):
            w = _leaf(want_params, path)
            np.testing.assert_allclose(got, w, rtol=0, atol=RTOL * max(1.0, np.abs(w).max()),
                                       err_msg=f"{name}: {path}")
    assert abs(ranks[0]["dp"]["loss"] - ranks[0]["3d"]["loss"]) < 1e-4


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", ["3d", "fsdp_tp"])
def test_per_rank_bytes_equal_the_reference_per_device_bytes(ranks, name):
    # parameters and Adam moments: each rank's local shards hold as many
    # bytes as one device of the reference's mesh (NamedSharding shard shapes)
    mesh = ref_make_mesh(RefMeshConfig(sp=1, **MESHES[name]), devices=jax.devices("cpu")[:8])
    init_fn, _ = ref_build_train_step(lambda p, b: ref_gpt_loss(REF_TINY, p, b, mesh), optax.adamw(1e-2), mesh)
    state = init_fn(ref_gpt_init(jax.random.PRNGKey(0), REF_TINY))

    def per_device(tree):
        return sum(int(np.prod(x.sharding.shard_shape(x.shape))) * x.dtype.itemsize
                   for x in jax.tree_util.tree_leaves(tree))

    mu_nu = [s for s in jax.tree_util.tree_leaves(state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
             if hasattr(s, "mu")]
    want_params = per_device(state.params)
    want_moments = sum(per_device(s.mu) + per_device(s.nu) for s in mu_nu)
    for r in ranks:
        res = r[name]
        assert res["all_dtensors"] and res["same_placements"]
        assert res["param_bytes"] == want_params, (res["param_bytes"], want_params)
        assert res["moment_bytes"] == want_moments == res["moment_bytes_after"]


def test_global_put(ranks):
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    for rank, r in enumerate(ranks):
        dp, fsdp, tp = rank // 4, (rank // 2) % 2, rank % 2
        row = (dp * 2 + fsdp) * 2  # batch over (dp, fsdp), dp outermost
        np.testing.assert_array_equal(r["global_put"]["local"], x[row:row + 2, tp * 3:tp * 3 + 3])
        np.testing.assert_array_equal(r["global_put"]["full"], x)
        assert r["global_put"]["placements"] == ["S(0)", "S(0)", "R", "R", "S(1)"]


@pytest.mark.parametrize("op", list(ReduceOp))
def test_mesh_allreduce(ranks, op):
    # the reference reduces x over axis 0 with its rows spread over the
    # mesh's first axis; every rank gets the result
    rng = np.random.RandomState(ALLREDUCE_SEED)
    x = rng.randint(-4, 5, size=(16, 5)).astype(np.float32)
    from ray_tpu.collective.collective import mesh_allreduce as ref_mesh_allreduce
    from ray_tpu.collective.types import ReduceOp as RefReduceOp

    want = np.asarray(ref_mesh_allreduce(jnp.asarray(x), op=RefReduceOp[op.name]))
    for r in ranks:
        np.testing.assert_array_equal(r["allreduce"][op.name], want)
        if op is ReduceOp.SUM:
            np.testing.assert_array_equal(r["allreduce_on"], want)


# tier-1 budget, as the reference's: the training loops ride slow
@pytest.mark.slow
@pytest.mark.parametrize("name", list(MESHES))
def test_train_step_loss_decreases(ranks, name):
    losses = ranks[0][name]["adam_losses"]
    assert all(r[name]["adam_losses"] == losses for r in ranks)
    assert losses[-1] < losses[0], f"no learning on a fixed batch: {losses}"
    ref_losses, _ = _ref_step(MESHES[name], optax.adamw(1e-2), steps=ADAM_STEPS)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
