"""ray_tpu_torch.parallel.pipeline against the reference, on the CPU — a
mirror of ``tests/test_pipeline.py``: GPipe microbatching over send and
receive between gloo ranks (``tests/torch_ranks.py``, one spawn of 4 ranks
for every case) must match sequential layer application and the
reference's ``pipeline_apply``, forward and gradients, within 1e-5 (fp32;
the stages run the same products in the same order, so only the
reference's XLA fusion can round differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from ray_tpu.parallel.pipeline import pipeline_apply as ref_pipeline_apply
from torch_ranks import run_ranks

TOL = dict(atol=1e-5, rtol=1e-5)


def _layers(n_layers, d, key):
    ks = jax.random.split(key, n_layers)
    return {
        "w": jnp.stack([jax.random.normal(k, (d, d)) * (d**-0.5) for k in ks]),
        "b": jnp.zeros((n_layers, d)),
    }


def _stage_fn(params, x):
    def body(h, layer):
        return jnp.tanh(h @ layer["w"] + layer["b"]), None

    out, _ = jax.lax.scan(body, x, params)
    return out


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


# (name, ranks, mesh shape, axis names, n_layers, microbatches, batch axes,
# gradients) and the reference's inputs for each
CASES = [
    ("pp2_m2", [0, 1], (2,), ("pp",), 8, 2, (), False),
    ("pp2_m4", [0, 1], (2,), ("pp",), 8, 4, (), False),
    ("pp4_m4", [0, 1, 2, 3], (4,), ("pp",), 8, 4, (), False),
    ("grads", [0, 1], (2,), ("pp",), 4, 2, (), True),
    ("dp2_pp2", [0, 1, 2, 3], (2, 2), ("dp", "pp"), 4, 2, (("dp",),), False),
    ("pp1", [0, 1], (2,), ("dp",), 4, 2, (), False),
]


def _data(name):
    d, n_layers, batch = {"grads": (8, 4, 4), "dp2_pp2": (8, 4, 8), "pp1": (8, 4, 4)}.get(name, (16, 8, 8))
    params = _layers(n_layers, d, jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (batch, d))
    tgt = jax.random.normal(jax.random.PRNGKey(2), (batch, d))
    return params, x, tgt


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    data = {}
    for name, *_ in CASES:
        params, x, tgt = _data(name)
        data[name] = {"params": _np(params), "x": np.asarray(x), "tgt": np.asarray(tgt)}
    return run_ranks(4, "pipeline_cases", {"cases": CASES, "data": data},
                     tmp_path_factory.mktemp("pipeline"))


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _outputs(ranks, name):
    members = _case(name)[1]
    outs = [ranks[r][name] for r in members]
    for o in outs[1:]:  # every stage returns the last stage's output
        np.testing.assert_array_equal(o, outs[0])
    return outs[0]


@pytest.mark.parametrize("pp,microbatches", [(2, 2), (2, 4), (4, 4)])
def test_pipeline_matches_sequential(ranks, pp, microbatches):
    name = f"pp{pp}_m{microbatches}"
    params, x, _ = _data(name)
    ref = _stage_fn(params, x)
    mesh = Mesh(np.array(jax.devices()[:pp]).reshape(pp), ("pp",))
    with mesh:
        ref_pp = jax.jit(lambda p, x: ref_pipeline_apply(_stage_fn, p, x, mesh, 8, microbatches,
                                                         batch_axes=()))(params, x)
    out = _outputs(ranks, name)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    np.testing.assert_allclose(out, np.asarray(ref_pp), **TOL)


def test_pipeline_gradients_match_sequential(ranks):
    params, x, tgt = _data("grads")

    def ref_loss(p):
        return ((_stage_fn(p, x) - tgt) ** 2).mean()

    g_ref = jax.grad(ref_loss)(params)
    for r in _case("grads")[1]:
        for k in ("w", "b"):
            np.testing.assert_allclose(ranks[r]["grads"][k], np.asarray(g_ref[k]), **TOL)


def test_pipeline_with_batch_sharding(ranks):
    """pp=2 combined with dp=2: batch sharded over dp, layers over pp."""
    params, x, _ = _data("dp2_pp2")
    np.testing.assert_allclose(_outputs(ranks, "dp2_pp2"), np.asarray(_stage_fn(params, x)), **TOL)


def test_pipeline_pp1_passthrough(ranks):
    params, x, _ = _data("pp1")
    np.testing.assert_allclose(_outputs(ranks, "pp1"), np.asarray(_stage_fn(params, x)), **TOL)
