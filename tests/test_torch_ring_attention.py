"""Ring attention (``ray_tpu_torch.ops.ring_attention``) and the GPT on a
mesh with an ``sp`` axis, against the reference on the CPU — a mirror of
``tests/test_attention.py``'s ring tests.

The port's ranks are gloo processes (``tests/torch_ranks.py``), 8 in one
launch: the dp 2 x tp 2 x sp 2 cases on every rank, the sp-4 and sp-1
cases on ranks 0-3. The reference runs on its virtual CPU devices in this
process, on the same numpy inputs. Tolerances are the reference's own:
2e-5 for the output, 5e-5 for the gradients, 2e-3 for the GPT forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.models.gpt import gpt_forward as ref_gpt_forward
from ray_tpu.models.gpt import gpt_init as ref_gpt_init
from ray_tpu.ops.attention import _xla_attention
from torch_ranks import Ranks

AXES = ("dp", "fsdp", "ep", "sp", "tp")
OUT_TOL, GRAD_TOL, GPT_TOL = 2e-5, 5e-5, 2e-3


def _axes(**sizes) -> dict:
    return {a: sizes.get(a, 1) for a in AXES}


EIGHT, FOUR = list(range(8)), list(range(4))
RING = {  # name: (ranks, mesh axes, (b, h, s, d), the weights of (out * w).sum())
    # test_attention.py::test_ring_attention_matches_dense
    "dense": (EIGHT, _axes(dp=2, tp=2, sp=2), (2, 4, 256, 32), np.cos),
    # test_attention.py::test_ring_attention_grads_match_dense
    "grads": (FOUR, _axes(sp=4), (1, 1, 128, 32), np.sin),
}
# test_attention.py::test_gpt_forward_with_ring_attention_matches_single
GPT = dict(vocab_size=256, seq_len=128, d_model=64, n_layers=2, n_heads=2, dtype="float32")
GPT_CASES = {  # name: (ranks, mesh axes, attention)
    "ring": (EIGHT, _axes(dp=2, tp=2, sp=2), "auto"),  # auto picks ring when sp > 1
    "xla_over_sp": (EIGHT, _axes(dp=2, tp=2, sp=2), "xla"),  # the sequence gathered for the einsum
    "ring_sp1": (FOUR, _axes(dp=2, tp=2), "ring"),  # one hop, no rotation
}


def _qkv(shape, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return [np.asarray(jax.random.normal(k, shape, jnp.float32)) for k in ks]


def _tokens() -> np.ndarray:
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, GPT["seq_len"] + 1), 0, 256, jnp.int32))


def _tree() -> dict:
    return jax.tree_util.tree_map(np.asarray, jax.device_get(ref_gpt_init(jax.random.PRNGKey(0),
                                                                          RefGPTConfig(**GPT))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = {}
    for name, (_, _, shape, wfn) in RING.items():
        q, k, v = _qkv(shape)
        data[name] = dict(q=q, k=k, v=v, w=wfn(np.arange(shape[-1])).astype(np.float32))
    ring = dict(cases=[(name, ranks, axes) for name, (ranks, axes, _, _) in RING.items()], data=data)
    gpt = dict(cases=[dict(name=name, ranks=ranks, axes=axes, cfg=dict(GPT, attn_impl=impl), tree="gpt",
                           tokens="gpt", what="forward") for name, (ranks, axes, impl) in GPT_CASES.items()],
               trees={"gpt": _tree()}, tokens={"gpt": _tokens().astype(np.int64)})
    ranks = Ranks(8, "several", [("ring_cases", ring), ("gpt_mesh_cases", gpt)],
                  tmp_path_factory.mktemp("ring_attention"))
    rcfg = RefGPTConfig(**GPT)
    ref_logits = np.asarray(ref_gpt_forward(rcfg, ref_gpt_init(jax.random.PRNGKey(0), rcfg),
                                            jnp.asarray(_tokens()[:, :-1])))
    return ranks.wait(), data, ref_logits


def _ref_grads(d):
    w = jnp.asarray(d["w"])
    return jax.grad(lambda q, k, v: (_xla_attention(q, k, v) * w).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(d[n]) for n in "qkv"))


def test_ring_attention_matches_dense(runs):
    """sp=2 ring attention (with dp 2 and tp 2) == dense causal."""
    got, data, _ = runs
    d = data["dense"]
    want = np.asarray(_xla_attention(*(jnp.asarray(d[n]) for n in "qkv")))
    for r in RING["dense"][0]:
        np.testing.assert_allclose(got[r][0]["dense"]["out"], want, atol=OUT_TOL)
    assert got[0][0]["dense"]["placements"] == ["S(0)", "S(0)", "R", "S(2)", "S(1)"]  # (dp, fsdp), ep, sp, tp


@pytest.mark.parametrize("name", list(RING))
def test_ring_attention_grads_match_dense(runs, name):
    """The gradients of (out * w).sum() through the rotations' backward
    (each sends the gradient the other way round the ring): sp 4, and sp 2
    under dp 2 x tp 2."""
    got, data, _ = runs
    want = _ref_grads(data[name])
    for r in RING[name][0]:
        for a, b in zip(want, got[r][0][name]["grads"]):
            np.testing.assert_allclose(b, np.asarray(a), atol=GRAD_TOL)


@pytest.mark.parametrize("name", list(GPT_CASES))
def test_gpt_forward_with_ring_attention_matches_single(runs, name):
    """The GPT forward on a dp 2 x tp 2 x sp 2 mesh (ring attention under
    "auto"; the einsum over the gathered sequence under "xla") and with
    ring attention on a mesh of sp 1: each rank's logits of its rows and
    positions equal the reference's one-device forward."""
    got, _, want = runs
    for r in GPT_CASES[name][0]:
        res = got[r][1][name]
        (row0, off), (b, s) = res["at"], res["logits"].shape[:2]
        np.testing.assert_allclose(res["logits"], want[row0:row0 + b, off:off + s], atol=GPT_TOL, rtol=GPT_TOL,
                                   err_msg=f"{name}: rank {r}")
        assert s == GPT["seq_len"] // GPT_CASES[name][1]["sp"]


def test_ring_without_a_mesh_raises_the_references_error():
    """``attn_impl="ring"`` needs a mesh, in both packages; ``gpt_init``
    takes the config."""
    import torch

    from ray_tpu_torch.models.gpt import GPTConfig, gpt_init, gpt_loss

    cfg = GPTConfig(**dict(GPT, attn_impl="ring"))
    params = gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_tokens().astype(np.int64))
    with pytest.raises(ValueError) as port_err:
        gpt_loss(cfg, params, tokens)
    rcfg = dataclasses.replace(RefGPTConfig(**GPT), attn_impl="ring")
    with pytest.raises(ValueError) as ref_err:
        ref_gpt_forward(rcfg, ref_gpt_init(jax.random.PRNGKey(0), rcfg), jnp.asarray(_tokens()[:, :-1]))
    assert str(port_err.value) == str(ref_err.value)
