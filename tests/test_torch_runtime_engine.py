"""The port's paged engine hosted in an actor of the port's runtime, on the
CPU: ray_tpu_torch vs ray_tpu.

As the reference's RLHF rollout worker hosts its engine
(``ray_tpu/rlhf/rollout.py:41-75``): the engine is built in the actor's
``__init__``, ``run_loop`` runs in a thread, and work is submitted and
gathered through ``.remote()`` calls. The actor builds a 2-layer GPT with
``device="cpu"`` from the reference's weights (``params_from_jax`` over the
numpy tree it gets from the object plane); its greedy tokens must equal the
reference engine's, plain and speculating. A weight push — the driver
``put``s a second seed's port parameters, the actor ``get``s them (a
zero-copy view of the store) and calls ``update_weights`` — must leave the
actor's tokens equal to a reference engine born on those weights.
"""

import sys

import cloudpickle
import numpy as np
import pytest
import torch

import jax

import ray_tpu_torch
from ray_tpu.llm import EngineConfig as RefEngineConfig
from ray_tpu.llm import LLMEngine as RefEngine
from ray_tpu.llm import SamplingParams as RefSamplingParams
from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.models.gpt import gpt_init as ref_gpt_init
from ray_tpu_torch.models.gpt import GPTConfig, params_from_jax

NARROW = dict(vocab_size=384, seq_len=40, d_model=64, n_layers=2, n_heads=4, dtype="float32")
REF_CFG = RefGPTConfig(**NARROW, remat=False, attn_impl="xla", fused_loss=False)
CFG = GPTConfig(**NARROW)
GEOMETRY = dict(max_slots=3, num_blocks=32, block_size=4, max_blocks_per_seq=12, prefill_chunk=8)
PERIODIC = [5, 9, 7, 5, 9, 7, 5, 9, 7, 5]

# the workers cannot import this test module: its actor class travels by value
cloudpickle.register_pickle_by_value(sys.modules[__name__])


class EngineHost:
    """The actor: a paged engine over weights fetched from the object plane
    (``params_ref`` rides in a list so the actor, not the runtime, gets
    it), ``run_loop`` in a thread."""

    def __init__(self, cfg, params_ref, geometry, spec_k=0):
        import threading

        import ray_tpu_torch
        from ray_tpu_torch.llm import EngineConfig, LLMEngine
        from ray_tpu_torch.models.gpt import params_from_jax

        tree = ray_tpu_torch.get(params_ref[0])
        self.engine = LLMEngine(cfg, params_from_jax(tree, cfg, "cpu"),
                                EngineConfig(**geometry, spec_k=spec_k), device="cpu")
        self.stop = threading.Event()
        self.loop = threading.Thread(target=self.engine.run_loop, args=(self.stop,), daemon=True)
        self.loop.start()
        self.pending = {}

    def submit(self, prompts, max_tokens):
        from ray_tpu_torch.llm import SamplingParams

        reqs = [self.engine.submit(list(p), SamplingParams(max_tokens=max_tokens)) for p in prompts]
        self.pending.update((r.id, r) for r in reqs)
        return [r.id for r in reqs]

    def gather(self, ids, timeout=120.0):
        out = []
        for rid in ids:
            req = self.pending.pop(rid)
            out.append(list(self.engine.stream_tokens(req, timeout=timeout)))
        return out

    def push(self, params_ref):
        """Weight push: the new parameters from the object plane, installed
        between two steps. Returns the version and whether every value
        arrived as a view of the shared-memory store."""
        import ray_tpu_torch
        from ray_tpu_torch._private.shm_store import shm_mapping_of

        new = ray_tpu_torch.get(params_ref[0])
        mapped = [shm_mapping_of(p.data_ptr()) is not None for p in new.parameters() if p.numel() >= 4096]
        return self.engine.update_weights(new), bool(mapped) and all(mapped)

    def stats(self):
        eng = self.engine
        return dict(verify_steps=eng.stats().get("verify_steps", 0), pool=eng.pool.audit()["ok"],
                    prefix=eng.prefix_cache.audit()["ok"], version=eng.weights_version)

    def shutdown(self):
        self.stop.set()
        self.loop.join(timeout=30)
        return not self.loop.is_alive()


@pytest.fixture(scope="module")
def weights():
    """{seed: (reference params, the numpy tree)}."""
    out = {}
    for seed in (0, 1):
        ref = ref_gpt_init(jax.random.PRNGKey(seed), REF_CFG)
        out[seed] = (ref, jax.device_get(ref))
    return out


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def _prompts():
    rng = np.random.RandomState(3)
    return [[int(t) for t in rng.randint(0, NARROW["vocab_size"], n)] for n in (9, 17, 4, 23)]


def _reference_tokens(ref_params, prompts, spec_k=0, max_tokens=8):
    eng = RefEngine(REF_CFG, ref_params, RefEngineConfig(**GEOMETRY, spec_k=spec_k))
    return [list(eng.generate(p, RefSamplingParams(max_tokens=max_tokens))) for p in prompts]


@pytest.mark.parametrize("spec_k", [0, 3], ids=["plain", "spec_k3"])
def test_actor_engine_matches_the_reference_engine(cluster, weights, spec_k):
    ref_params, tree = weights[0]
    prompts = _prompts() + ([PERIODIC] if spec_k else [])
    host = ray_tpu_torch.remote(EngineHost).options(max_concurrency=4).remote(
        CFG, [ray_tpu_torch.put(tree)], GEOMETRY, spec_k)
    ids = ray_tpu_torch.get(host.submit.remote(prompts, 8), timeout=120)
    got = ray_tpu_torch.get(host.gather.remote(ids), timeout=120)
    assert got == _reference_tokens(ref_params, prompts, spec_k)
    st = ray_tpu_torch.get(host.stats.remote(), timeout=60)
    assert st["pool"] and st["prefix"]
    if spec_k:
        assert st["verify_steps"] > 0
    assert ray_tpu_torch.get(host.shutdown.remote(), timeout=60)
    ray_tpu_torch.kill(host)


def test_weight_push_through_the_object_plane(cluster, weights):
    """The driver puts seed 1's port parameters; the actor gets them as
    views of the store and swaps them in between steps; its tokens then
    equal a reference engine born on seed 1's weights (and differ from seed
    0's)."""
    _, tree0 = weights[0]
    ref1, tree1 = weights[1]
    host = ray_tpu_torch.remote(EngineHost).options(max_concurrency=4).remote(
        CFG, [ray_tpu_torch.put(tree0)], GEOMETRY)
    prompts = _prompts()
    before = ray_tpu_torch.get(host.gather.remote(ray_tpu_torch.get(host.submit.remote(prompts, 8))),
                               timeout=120)
    new = params_from_jax(tree1, CFG, "cpu")
    version, zero_copy = ray_tpu_torch.get(host.push.remote([ray_tpu_torch.put(new)]), timeout=120)
    assert version == 1 and zero_copy
    after = ray_tpu_torch.get(host.gather.remote(ray_tpu_torch.get(host.submit.remote(prompts, 8))),
                              timeout=120)
    assert after == _reference_tokens(ref1, prompts)
    assert after != before
    st = ray_tpu_torch.get(host.stats.remote(), timeout=60)
    assert st["version"] == 1 and st["pool"] and st["prefix"]
    # the put value itself is unchanged by the swap (the engine copied it)
    again = ray_tpu_torch.get(ray_tpu_torch.put(new), timeout=60)
    assert all(torch.equal(a, b) for a, b in zip(new.parameters(), again.parameters()))
    assert ray_tpu_torch.get(host.shutdown.remote(), timeout=60)
    ray_tpu_torch.kill(host)


def test_actor_engine_on_the_card_needs_a_gpu(cluster, weights):
    """Asked for the card (``num_gpus=1``) on a cluster without one, the
    actor is refused and its calls raise: the engine never comes up on the
    CPU in its place."""
    _, tree = weights[0]
    host = ray_tpu_torch.remote(EngineHost).options(num_gpus=1).remote(CFG, [ray_tpu_torch.put(tree)], GEOMETRY)
    with pytest.raises(ray_tpu_torch.exceptions.ActorDiedError, match="has a GPU"):
        ray_tpu_torch.get(host.stats.remote(), timeout=60)
