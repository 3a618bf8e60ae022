"""A mixture-of-experts GPT of the port on a device mesh, against the
reference — a mirror of ``tests/test_moe.py``'s mesh tests, with what the
port adds: routing over the global batch on a dp mesh, one SGD step on ep,
tp, dp and sp meshes against the reference's step on the same mesh, and
per-rank bytes on an ep mesh.

The port's ranks are gloo processes (``tests/torch_ranks.py``): one launch
of 4 ranks computes every case (the dp-2 case on ranks 0 and 1), while the
reference runs on its virtual CPU devices in this process. Both start from
the reference's ``gpt_init`` weights (``params_from_jax``) and one batch.
The configuration is ``test_moe.py``'s (vocab 256, seq 64, d 64, 2 layers,
2 heads, fp32, 4 experts top-2), at capacity factor 0.5 where assignments
must drop. Tolerances: the reference's own EP tolerance, 2e-3, for logits,
aux and loss against its one-device forward; the loss and parameters after
one SGD step within ``RTOL`` 1e-5 of the reference's same-mesh step (of the
largest |value| for parameters), as ``test_torch_parallel.py`` holds the
dense model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.models.gpt import gpt_forward as ref_gpt_forward
from ray_tpu.models.gpt import gpt_init as ref_gpt_init
from ray_tpu.models.gpt import gpt_loss as ref_gpt_loss
from ray_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from ray_tpu.parallel.mesh import make_mesh as ref_make_mesh
from ray_tpu.parallel.sharding import batch_spec as ref_batch_spec
from ray_tpu.parallel.train_step import build_train_step as ref_build_train_step
from torch_ranks import Ranks

MOE = dict(vocab_size=256, seq_len=64, d_model=64, n_layers=2, n_heads=2, dtype="float32", n_experts=4,
           experts_per_token=2)
DROPS = dict(MOE, capacity_factor=0.5)
EP_TOL = 2e-3
RTOL = 1e-5
FULL = (0, 1, 2, 3)
AXES = ("dp", "fsdp", "ep", "sp", "tp")


def _axes(**sizes) -> dict:
    return {a: sizes.get(a, 1) for a in AXES}


FORWARD = {  # name: (ranks, mesh axes, config, batch rows)
    # the fault: each rank routed its batch slice alone (its capacity, its
    # slot order, its aux)
    "dp2": ((0, 1), _axes(dp=2), DROPS, 4),
    # test_moe.py::test_moe_ep_sharding_matches_single_device
    "ep2_tp2": (FULL, _axes(ep=2, tp=2), MOE, 2),
}
STEPS = {"ep2_tp2": _axes(ep=2, tp=2), "dp2_ep2": _axes(dp=2, ep=2), "sp2_dp2": _axes(sp=2, dp=2),
         "sp2_ep2": _axes(sp=2, ep=2)}
BYTES = {"ep2_tp2": _axes(ep=2, tp=2), "dp2_ep2": _axes(dp=2, ep=2)}
STEP_ROWS = 4


def _tokens(rows: int) -> np.ndarray:
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (rows, MOE["seq_len"] + 1), 0, 256, jnp.int32))


def _tree(cfg: dict) -> dict:
    return jax.tree_util.tree_map(np.asarray, jax.device_get(ref_gpt_init(jax.random.PRNGKey(0),
                                                                          RefGPTConfig(**cfg))))


def _ref_mesh(axes: dict):
    return ref_make_mesh(RefMeshConfig(**axes), devices=jax.devices("cpu")[:int(np.prod(list(axes.values())))])


def _ref_forward(cfg: dict, rows: int) -> dict:
    """The reference's one-device logits, aux and loss."""
    rcfg, tokens = RefGPTConfig(**cfg), jnp.asarray(_tokens(rows))
    params = ref_gpt_init(jax.random.PRNGKey(0), rcfg)
    logits, aux = ref_gpt_forward(rcfg, params, tokens[:, :-1], return_aux=True)
    return dict(logits=np.asarray(logits), aux=float(aux), loss=float(ref_gpt_loss(rcfg, params, tokens)))


def _ref_step(axes: dict, optimizer):
    """The reference's step on its mesh of the same axes: (loss, params)."""
    from jax.sharding import NamedSharding

    rcfg, mesh = RefGPTConfig(**DROPS), _ref_mesh(axes)
    init_fn, step_fn = ref_build_train_step(lambda p, b: ref_gpt_loss(rcfg, p, b, mesh), optimizer, mesh)
    state = init_fn(ref_gpt_init(jax.random.PRNGKey(0), rcfg))
    batch = jax.device_put(jnp.asarray(_tokens(STEP_ROWS)), NamedSharding(mesh, ref_batch_spec()))
    state, loss = step_fn(state, batch)
    return float(loss), jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))


def _ref_bytes(axes: dict) -> tuple:
    """Per-device parameter and AdamW moment bytes on the reference's mesh."""
    rcfg, mesh = RefGPTConfig(**DROPS), _ref_mesh(axes)
    init_fn, _ = ref_build_train_step(lambda p, b: ref_gpt_loss(rcfg, p, b, mesh), optax.adamw(1e-2), mesh)
    state = init_fn(ref_gpt_init(jax.random.PRNGKey(0), rcfg))

    def per_device(tree):
        return sum(int(np.prod(x.sharding.shard_shape(x.shape))) * x.dtype.itemsize
                   for x in jax.tree_util.tree_leaves(tree))

    mu_nu = [s for s in jax.tree_util.tree_leaves(state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
             if hasattr(s, "mu")]
    return per_device(state.params), sum(per_device(s.mu) + per_device(s.nu) for s in mu_nu)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case in one launch of 4 ranks; the reference's results are
    computed while the ranks run."""
    cases = [dict(name=f"forward_{n}", ranks=list(r), axes=a, cfg=c, tree="drops" if c is DROPS else "moe",
                  tokens=f"rows{rows}", what="forward") for n, (r, a, c, rows) in FORWARD.items()]
    cases += [dict(name=f"sgd_{n}", ranks=list(FULL), axes=a, cfg=DROPS, tree="drops", tokens=f"rows{STEP_ROWS}",
                   what="sgd") for n, a in STEPS.items()]
    cases += [dict(name=f"bytes_{n}", ranks=list(FULL), axes=a, cfg=DROPS, tree="drops", tokens=f"rows{STEP_ROWS}",
                   what="bytes") for n, a in BYTES.items()]
    payload = dict(cases=cases, trees={"moe": _tree(MOE), "drops": _tree(DROPS)},
                   tokens={f"rows{n}": _tokens(n).astype(np.int64) for n in (2, 4)})
    ranks = Ranks(4, "gpt_mesh_cases", payload, tmp_path_factory.mktemp("moe_mesh"))
    ref = {f"forward_{n}": _ref_forward(c, rows) for n, (_, _, c, rows) in FORWARD.items()}
    ref.update({f"sgd_{n}": _ref_step(a, optax.sgd(0.1)) for n, a in STEPS.items()})
    ref.update({f"bytes_{n}": _ref_bytes(a) for n, a in BYTES.items()})
    return ranks.wait(), ref


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


@pytest.mark.parametrize("name", list(FORWARD))
def test_moe_on_a_mesh_matches_single_device(runs, name):
    """Each rank's logits are the reference's one-device logits of its
    rows and positions, and every rank's aux and loss the global batch's.
    ``dp2`` is the fault this slice repaired: each rank routed its batch
    slice alone, with a capacity from its own tokens, its own slot order
    and its own aux, so assignments dropped that the reference keeps."""
    got, ref = runs
    key = f"forward_{name}"
    want = ref[key]
    ranks = FORWARD[name][0]
    for r in ranks:
        res = got[r][key]
        (row0, off), (b, s) = res["at"], res["logits"].shape[:2]
        np.testing.assert_allclose(res["logits"], want["logits"][row0:row0 + b, off:off + s], atol=EP_TOL,
                                   rtol=EP_TOL, err_msg=f"{name}: rank {r}")
        np.testing.assert_allclose(res["aux"], want["aux"], atol=EP_TOL, rtol=EP_TOL, err_msg=f"{name}: rank {r}")
        np.testing.assert_allclose(res["loss"], want["loss"], atol=EP_TOL, rtol=EP_TOL, err_msg=f"{name}: rank {r}")
    covered = sum(got[r][key]["logits"].shape[0] for r in ranks if got[r][key]["at"][1] == 0)
    assert covered >= want["logits"].shape[0]  # the ranks' slices cover the batch


@pytest.mark.parametrize("name", list(STEPS))
def test_one_sgd_step_matches_the_references_same_mesh_step(runs, name):
    """One SGD step of the MoE GPT at capacity 0.5 on ep x tp, dp x ep, sp x
    dp (ring attention) and sp x ep: the loss, the same on every rank, and
    every parameter after the step equal the reference's step on its mesh
    of the same axes."""
    got, ref = runs
    key = f"sgd_{name}"
    want_loss, want_params = ref[key]
    losses = [r[key]["loss"] for r in got]
    assert len(set(losses)) == 1, (name, losses)
    assert abs(losses[0] - want_loss) <= RTOL * abs(want_loss), (name, losses[0], want_loss)
    for path, value in _leaves(got[0][key]["params"]):
        w = _leaf(want_params, path)
        np.testing.assert_allclose(value, w, rtol=0, atol=RTOL * max(1.0, np.abs(w).max()),
                                   err_msg=f"{name}: {path}")


@pytest.mark.parametrize("name", list(BYTES))
def test_per_rank_bytes_on_an_ep_mesh_equal_the_references(runs, name):
    """Parameters and AdamW moments: each rank's local shards (the experts
    over ep) hold as many bytes as one device of the reference's mesh."""
    got, ref = runs
    want_params, want_moments = ref[f"bytes_{name}"]
    for r in got:
        res = r[f"bytes_{name}"]
        assert (res["param_bytes"], res["moment_bytes"]) == (want_params, want_moments), (name, res)


# tier-1 budget, as the reference's: the training loop rides slow
@pytest.mark.slow
def test_moe_trains_loss_decreases(tmp_path):
    """test_moe.py::test_moe_trains_loss_decreases: AdamW 1e-3 on dp 2 x ep 2
    x tp 2, 6 steps over one batch of 4 rows: the loss falls, the same on
    every rank."""
    case = dict(name="adam", ranks=list(range(8)), axes=_axes(dp=2, ep=2, tp=2), cfg=MOE, tree="moe",
                tokens="rows4", what="adam", steps=6)
    payload = dict(cases=[case], trees={"moe": _tree(MOE)}, tokens={"rows4": _tokens(4).astype(np.int64)})
    got = Ranks(8, "gpt_mesh_cases", payload, tmp_path).wait()
    losses = got[0]["adam"]["losses"]
    assert all(r["adam"]["losses"] == losses for r in got)
    assert losses[-1] < losses[0], losses
