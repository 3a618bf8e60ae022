"""ray_tpu_torch.train.integrations (the HuggingFace weight loaders) and
``models.gptj.gptj_loss`` against the reference, on the CPU — a mirror of
the HF and GPT-J cases of ``tests/test_train_integrations.py``.

The transformers models are built in code from ``GPT2Config``/
``GPTJConfig`` (no downloads), in a subprocess of their own: importing
transformers' model classes adds several hundred thousand objects to a
process (TensorFlow too, where it is installed), which would slow every
later ``gc.collect()`` in the test worker that ran this file. The same HF
model goes through the reference's loader and the port's: the port's
forward must equal the reference's within 1e-4 (both fp32; summation order
only) and HF's within the reference's own 2e-3; greedy decode must be
token-identical to the reference's and to HF ``generate``. ``gptj_loss``
(fused and unfused) is held against the reference's on the reference's
``gptj_init`` weights within 1e-5 relative, its gradients within 1e-4.
The orbax bridge (on ``torch.distributed.checkpoint``) and the module
bridge (the reference's flax bridge, for ``nn.Module``s) are held against
the reference's TestOrbax and TestFlaxBridge at the end of the file, their
multi-rank cases in gloo processes (``tests/torch_ranks.py``).
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gptj as ref_gptj
from ray_tpu_torch.models import gptj
from ray_tpu_torch.train import integrations

REPO = Path(__file__).resolve().parents[1]
needs_transformers = pytest.mark.skipif(importlib.util.find_spec("transformers") is None,
                                        reason="transformers is not installed")

HF_WORKLOAD = r'''
import dataclasses, json, sys

import numpy as np
import torch
import transformers
import jax.numpy as jnp

from ray_tpu.models import gpt as ref_gpt
from ray_tpu.models import gptj as ref_gptj
from ray_tpu.train import integrations as ref_integrations
from ray_tpu_torch.models import gpt, gptj
from ray_tpu_torch.train import integrations

torch.set_num_threads(2)
out = {}


def tokens(seed, shape, vocab=96):
    return np.random.RandomState(seed).randint(0, vocab, size=shape).astype(np.int32)


def fields(cfg, names):
    return [getattr(cfg, n) for n in names]


# configs
hf = transformers.GPT2Config(vocab_size=500, n_positions=128, n_embd=96, n_layer=3, n_head=4)
names = ["vocab_size", "seq_len", "d_model", "n_layers", "n_heads", "dtype"]
cfg = integrations.gpt_config_from_hf(hf, dtype="float32")
out["gpt_config"] = [type(cfg).__module__, fields(cfg, names),
                     fields(ref_integrations.gpt_config_from_hf(hf, dtype="float32"), names)]
hfj = transformers.GPTJConfig(vocab_size=500, n_positions=128, n_embd=96, n_layer=3, n_head=4,
                              rotary_dim=None)
cfgj = integrations.gptj_config_from_hf(hfj, remat=False, attn_impl="xla")
refj = ref_integrations.gptj_config_from_hf(hfj, remat=False, attn_impl="xla")
names_j = [f.name for f in dataclasses.fields(cfgj)]
out["gptj_config"] = [type(cfgj).__module__, fields(cfgj, names_j), fields(refj, names_j)]

# GPT-2
torch.manual_seed(0)
hf_gpt2 = transformers.GPT2LMHeadModel(transformers.GPT2Config(
    vocab_size=96, n_positions=32, n_embd=64, n_layer=2, n_head=2,
    resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)).eval()
cfg, model = integrations.load_hf_gpt2(hf_gpt2, device="cpu")
ref_cfg, ref_params = ref_integrations.load_hf_gpt2(hf_gpt2)
cfg = dataclasses.replace(cfg, dtype="float32", remat=False)
ref_cfg = dataclasses.replace(ref_cfg, dtype="float32", remat=False, attn_impl="xla")
t = tokens(0, (2, 16))
with torch.no_grad():
    want_hf = hf_gpt2(torch.from_numpy(t.astype(np.int64))).logits.numpy()
    got = gpt.gpt_forward(cfg, model, torch.from_numpy(t)).numpy()
want = np.asarray(ref_gpt.gpt_forward(ref_cfg, ref_params, jnp.asarray(t)))
out["gpt2_forward"] = [float(np.abs(got - want).max()), float(np.abs(got - want_hf).max())]
cfg, model = integrations.load_hf_gpt2(hf_gpt2, pad_vocab_to_multiple=128, device="cpu")
out["gpt2_padding"] = [cfg.vocab_size, list(model.embed.weight.shape), list(model.lm_head.weight.shape),
                       float(model.embed.weight[96:].detach().abs().max())]
try:
    integrations.load_hf_gpt2(hf_gpt2.state_dict(), device="cpu")
    out["gpt2_no_cfg"] = None
except ValueError as e:
    out["gpt2_no_cfg"] = str(e)

# GPT-J
torch.manual_seed(0)
hf_gptj = transformers.GPTJForCausalLM(transformers.GPTJConfig(
    vocab_size=96, n_positions=32, n_embd=64, n_layer=3, n_head=4, rotary_dim=8,
    attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0)).eval()
cfg32 = dataclasses.replace(integrations.gptj_config_from_hf(hf_gptj.config), dtype="float32")
cfg, model = integrations.load_hf_gptj(hf_gptj, cfg=cfg32, device="cpu")
ref_cfg, ref_params = ref_integrations.load_hf_gptj(hf_gptj)
ref_cfg = dataclasses.replace(ref_cfg, dtype="float32", remat=False, attn_impl="xla", fused_loss=False)
t = tokens(0, (2, 16))
with torch.no_grad():
    want_hf = hf_gptj(torch.from_numpy(t.astype(np.int64))).logits.numpy()
got = gptj.gptj_forward(cfg, model, torch.from_numpy(t)).numpy()
want = np.asarray(ref_gptj.gptj_forward(ref_cfg, ref_params, jnp.asarray(t)))
out["gptj_forward"] = [float(np.abs(got - want).max()), float(np.abs(got - want_hf).max())]
prompt = tokens(2, (1, 7))
with torch.no_grad():
    hf_tokens = hf_gptj.generate(torch.from_numpy(prompt.astype(np.int64)), max_new_tokens=6,
                                 do_sample=False, pad_token_id=0).numpy()
out["gptj_decode"] = [gptj.gptj_decode(cfg, model, torch.from_numpy(prompt).long(), 6).numpy().tolist(),
                      np.asarray(ref_gptj.gptj_decode(ref_cfg, ref_params, jnp.asarray(prompt), 6)).tolist(),
                      hf_tokens.tolist()]
cfg, model = integrations.load_hf_gptj(hf_gptj, cfg=cfg32, pad_vocab_to_multiple=128, device="cpu")
logits = gptj.gptj_forward(cfg, model, torch.from_numpy(tokens(1, (1, 8)))).numpy()
out["gptj_padding"] = [cfg.vocab_size, float(logits[..., 96:].max())]
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(autouse=True, scope="module")
def _hf_process():
    """The HF workload in a fresh process, started with the module so that
    it runs while the in-process tests run (the HF tests come last)."""
    if importlib.util.find_spec("transformers") is None:
        yield None
        return
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu", "USE_TF": "0"}
    proc = subprocess.Popen([sys.executable, "-c", HF_WORKLOAD], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        yield proc
    finally:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def hf(_hf_process):
    """The HF workload's answers."""
    out, err = _hf_process.communicate(timeout=300)
    assert _hf_process.returncode == 0, out[-4000:] + err[-4000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tokens(seed, shape, vocab=96):
    return np.random.RandomState(seed).randint(0, vocab, size=shape).astype(np.int32)


GPTJ_TINY = dict(vocab_size=96, seq_len=32, d_model=64, n_layers=3, n_heads=4, rotary_dim=8,
                 dtype="float32")


@pytest.fixture(scope="module")
def ref_tree():
    """The reference's GPT-J weights (``gptj_init``), shared by both sides."""
    return jax.device_get(ref_gptj.gptj_init(jax.random.PRNGKey(0), ref_gptj.GPTJConfig(**GPTJ_TINY)))


def _gptj_pair(tree, **over):
    cfg = gptj.GPTJConfig(**GPTJ_TINY, **over)
    ref_cfg = ref_gptj.GPTJConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    return cfg, gptj.params_from_jax(tree, cfg, "cpu").requires_grad_(True), ref_cfg


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_gptj_loss_matches_reference(ref_tree, fused):
    """``gptj_loss`` (remat "full", the default; attention "xla" on both
    sides, since the reference's "auto" runs Pallas in interpret mode off
    the TPU) and its gradients against ``jax.value_and_grad`` of the
    reference's."""
    cfg, model, ref_cfg = _gptj_pair(ref_tree, attn_impl="xla", fused_loss=fused)
    tokens = _tokens(3, (2, 17))
    loss = gptj.gptj_loss(cfg, model, torch.from_numpy(tokens))
    loss.backward()
    want, grads = jax.value_and_grad(
        lambda p: ref_gptj.gptj_loss(ref_cfg, p, jnp.asarray(tokens)))(ref_tree)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    pairs = [
        (model.lm_head.bias.grad, grads["lm_head"]["bias"]),
        (model.lm_head.weight.grad.T, grads["lm_head"]["kernel"]),
        (model.embed.weight.grad, grads["embed"]["tokens"]),
        (model.blocks[0].q.weight.grad.T, grads["blocks"]["q"]["kernel"][0]),
        (model.blocks[2].mlp_out.weight.grad.T, grads["blocks"]["mlp_out"]["kernel"][2]),
        (model.ln_f.scale.grad, grads["ln_f"]["scale"]),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_gptj_loss_is_the_same_under_every_remat_policy(ref_tree):
    """remat off, "full", "attn" and "dots" give the same loss and gradients
    (the flash op's plain version on the CPU in the "attn" and "dots"
    runs), and a policy GPT-J does not have raises."""
    tokens = torch.from_numpy(_tokens(4, (2, 13)))
    runs = []
    for over in (dict(remat=False, attn_impl="xla"), dict(remat_policy="full", attn_impl="xla"),
                 dict(remat_policy="attn", attn_impl="flash"),
                 dict(remat_policy="dots", attn_impl="flash")):
        cfg, model, _ = _gptj_pair(ref_tree, **over)
        loss = gptj.gptj_loss(cfg, model, tokens)
        loss.backward()
        runs.append((loss.item(), [p.grad.clone() for p in model.parameters()]))
    for loss, grads in runs[1:]:
        np.testing.assert_allclose(loss, runs[0][0], rtol=1e-6)
        for g, g0 in zip(grads, runs[0][1]):
            torch.testing.assert_close(g, g0, atol=1e-5, rtol=1e-5)
    cfg, model, _ = _gptj_pair(ref_tree, remat_policy="big")
    with pytest.raises(ValueError, match="remat_policy"):
        gptj.gptj_loss(cfg, model, tokens)


def test_gptj_loss_on_the_card_raises_for_head_dim_256(monkeypatch):
    """GPT-J-6B's head dim (256) is not one the flash kernels K3-K5 take:
    on the card (tensors that say they are there) ``gptj_loss`` raises as
    the kernels do and never takes the plain attention."""
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = gptj.GPTJConfig(vocab_size=32, seq_len=8, d_model=512, n_layers=1, n_heads=2,
                          rotary_dim=8, dtype="float32")
    model = gptj.gptj_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert cfg.head_dim == 256
    tokens = torch.from_numpy(_tokens(5, (1, 8), vocab=32))
    launches = fa.flash_fwd_cuda.launches
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(ValueError, match="head_dim in"):
        gptj.gptj_loss(cfg, model, tokens)
    assert fa.flash_fwd_cuda.launches == launches


@pytest.mark.parametrize("name", ["save_pytree_checkpoint", "load_pytree_checkpoint",
                                  "build_flax_train_step", "flax_sharding_rules"])
def test_orbax_and_flax_bridges_are_not_ported(name):
    """The reference's names: the orbax pair is ported under its names (on
    ``torch.distributed.checkpoint``), the flax pair by design as the
    module bridge, so the flax names raise ``AttributeError`` naming
    their counterparts (the name of this test predates the port)."""
    from ray_tpu_torch.train.integrations import module_bridge, orbax

    ported = {"save_pytree_checkpoint": orbax.save_pytree_checkpoint,
              "load_pytree_checkpoint": orbax.load_pytree_checkpoint}
    renamed = {"build_flax_train_step": "build_module_train_step",
               "flax_sharding_rules": "module_sharding_rules"}
    if name in ported:
        assert getattr(integrations, name) is ported[name]
        scope: dict = {}
        exec(f"from ray_tpu_torch.train.integrations import {name}", scope)
        assert scope[name] is ported[name]
    else:
        with pytest.raises(AttributeError, match=renamed[name]):
            getattr(integrations, name)
        with pytest.raises(ImportError, match=name):
            exec(f"from ray_tpu_torch.train.integrations import {name}", {})
        assert callable(getattr(module_bridge, renamed[name]))


# the orbax bridge (torch.distributed.checkpoint) and the module bridge
# against the reference's TestOrbax and TestFlaxBridge


def test_orbax_roundtrip(tmp_path):
    from ray_tpu.train.integrations import load_pytree_checkpoint as ref_load
    from ray_tpu.train.integrations import save_pytree_checkpoint as ref_save

    w = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    ref = ref_load(ref_save({"params": {"w": jnp.asarray(w), "b": jnp.zeros(4)}, "step": jnp.int32(7)},
                            str(tmp_path / "ref")))
    state = {"params": {"w": torch.from_numpy(w), "b": torch.zeros(4)}, "step": 7}
    ckpt = integrations.save_pytree_checkpoint(state, str(tmp_path / "ck"))
    assert os.listdir(tmp_path / "ck") == ["pytree"]  # the reference's subdirectory, DCP's files
    restored = integrations.load_pytree_checkpoint(ckpt)
    np.testing.assert_array_equal(restored["params"]["w"].numpy(), np.asarray(ref["params"]["w"]))
    np.testing.assert_array_equal(restored["params"]["b"].numpy(), np.asarray(ref["params"]["b"]))
    assert restored["step"] == int(ref["step"]) == 7


@pytest.fixture(scope="module")
def tiny_payload():
    from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
    from ray_tpu.models.gpt import gpt_init as ref_gpt_init

    fields = dict(vocab_size=256, seq_len=64, d_model=64, n_layers=2, n_heads=4, dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(
        ref_gpt_init(jax.random.PRNGKey(0), RefGPTConfig(**fields))))
    batch = np.random.RandomState(3).randint(0, 256, (8, fields["seq_len"] + 1))
    return dict(cfg=fields, tree=tree, batch=batch)


def _assert_same_trees(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_restore_with_target_structure(tmp_path, tiny_payload):
    """A train state saved by 4 ranks (fsdp 4: one file of shards each)
    restores onto 2 (fsdp 2) through a target of the fresh state: the
    parameters and AdamW moments equal bit for bit, and the next step's
    loss agrees within 1e-5 relative (the two meshes split the batch
    differently, so the gradients' sums round differently). The reference
    restores a target's structure the same way."""
    from ray_tpu.train.integrations import load_pytree_checkpoint as ref_load
    from ray_tpu.train.integrations import save_pytree_checkpoint as ref_save
    from torch_ranks import run_ranks

    ref_save({"w": jnp.ones((4, 4)), "n": jnp.int32(3)}, str(tmp_path / "ref"))
    ref = ref_load(str(tmp_path / "ref"), target={"w": jnp.zeros((4, 4)), "n": jnp.int32(0)})
    np.testing.assert_array_equal(ref["w"], np.ones((4, 4)))

    payload = dict(tiny_payload, path=str(tmp_path / "ck"), save_mesh=dict(dp=1, fsdp=-1),
                   restore_mesh=dict(dp=1, fsdp=-1))
    saved = run_ranks(4, "checkpoint_save", payload, tmp_path / "save")
    restored = run_ranks(2, "checkpoint_restore", payload, tmp_path / "restore")
    assert saved[0]["files"] == [".metadata"] + [f"__{r}_0.distcp" for r in range(4)]
    for r in restored:
        assert r["placements"] == saved[0]["placements"]  # the rule table's, on a mesh half the size
        assert r["step"] == saved[0]["step"] == 2
        _assert_same_trees(r["params"], saved[0]["params"])
        _assert_same_trees(r["moments"], saved[0]["moments"])
        assert abs(r["next_loss"] - saved[0]["next_loss"]) <= 1e-5 * abs(saved[0]["next_loss"])


def test_restore_onto_another_tp(tmp_path, tiny_payload):
    """A train state saved at (fsdp 2, tp 2), where each tp rank keeps its
    heads' rows of the fused qkv (``sharding.qkv_order``), restores at fsdp
    4 with tp 1: the checkpoint holds the fused qkv and its moments in the
    unsharded order, so the parameters and AdamW moments equal the
    source's (``params_to_numpy``) bit for bit, and the next step's loss
    agrees within 1e-5 relative."""
    from torch_ranks import run_ranks

    payload = dict(tiny_payload, path=str(tmp_path / "ck"), save_mesh=dict(dp=1, fsdp=2, tp=2),
                   restore_mesh=dict(dp=1, fsdp=4, tp=1))
    saved = run_ranks(4, "checkpoint_save", payload, tmp_path / "save")
    restored = run_ranks(4, "checkpoint_restore", payload, tmp_path / "restore")
    assert "(Replicate(), Shard(dim=1), Shard(dim=0))" in saved[0]["placements"]  # qkv: tp on its rows
    for r in restored:
        assert r["step"] == saved[0]["step"] == 2
        _assert_same_trees(r["params"], saved[0]["params"])
        _assert_same_trees(r["moments"], saved[0]["moments"])
        assert abs(r["next_loss"] - saved[0]["next_loss"]) <= 1e-5 * abs(saved[0]["next_loss"])


def test_session_report_carries_orbax_checkpoint(tmp_path):
    """End-to-end: a TorchTrainer worker saves a checkpoint through
    session.report and the Result hands it back."""
    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    def loop(config):
        import os

        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.train.integrations import save_pytree_checkpoint

        rank = train.get_context().get_world_rank()
        ckpt = save_pytree_checkpoint({"w": torch.full((2, 2), 5.0)}, os.path.join(config["dir"], f"rank{rank}"))
        train.report({"loss": 1.0}, checkpoint=ckpt)

    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    try:
        result = TorchTrainer(loop, train_loop_config={"dir": str(tmp_path / "loop")},
                              scaling_config=ScalingConfig(num_workers=1),
                              run_config=RunConfig(name="dcp", storage_path=str(tmp_path / "runs"))).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert result.error is None and result.checkpoint is not None
    restored = integrations.load_pytree_checkpoint(result.checkpoint)
    np.testing.assert_array_equal(restored["w"].numpy(), np.full((2, 2), 5.0))
    assert train is not None


class TestModuleBridge:
    """The reference's flax bridge test on an ``nn.Module``: an MLP (32 ->
    256 -> relu -> 8) from the reference's flax weights trains on a (dp 2,
    fsdp 2) mesh of gloo ranks (the reference's runs dp 2 x fsdp 4), its
    large weights scattered over fsdp; its Adam losses agree with the
    reference's over the first 3 steps (one batch, fp32): step 0's within
    1e-5 relative, then within 1e-4, since Adam's first update moves every
    element by lr whatever its gradient's size, so an element whose
    near-zero gradient rounds to the other sign moves by 2 lr. They fall
    as the reference's test requires."""

    STEPS = 12

    @pytest.fixture(scope="class")
    def ranks(self, tmp_path_factory):
        import flax.linen as nn
        import optax

        from ray_tpu.parallel.mesh import MeshConfig, make_mesh
        from ray_tpu.train.integrations.flax_bridge import build_flax_train_step
        from torch_ranks import run_ranks

        class MLP(nn.Module):
            @nn.compact
            def __call__(self, batch):
                x = nn.Dense(256)(batch["x"])  # Dense_0: flax names layers in creation order
                return nn.Dense(8)(nn.relu(x))

        def loss_fn(apply_fn, params, batch):
            logits = apply_fn({"params": params}, batch)
            return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * jax.nn.one_hot(batch["y"], 8), axis=-1))

        rs = np.random.RandomState(0)
        batch = {"x": rs.randn(16, 32).astype(np.float32), "y": rs.randint(0, 8, 16).astype(np.int32)}
        mesh = make_mesh(MeshConfig(dp=2, fsdp=4, tp=1, sp=1))
        init_fn, step_fn = build_flax_train_step(MLP(), loss_fn, optax.adam(1e-2), mesh, batch,
                                                 min_shard_size=1024)
        state = init_fn()
        p = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
        weights = {"fc1.weight": p["Dense_0"]["kernel"].T.copy(), "fc1.bias": p["Dense_0"]["bias"],
                   "fc2.weight": p["Dense_1"]["kernel"].T.copy(), "fc2.bias": p["Dense_1"]["bias"]}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        ref_losses = []
        for _ in range(self.STEPS):
            state, loss = step_fn(state, jb)
            ref_losses.append(float(loss))
        out = run_ranks(4, "module_bridge_steps", dict(weights=weights, batch=batch, steps=self.STEPS),
                        tmp_path_factory.mktemp("module_bridge"))
        return out, ref_losses

    def test_flax_module_trains_sharded(self, ranks):
        out, ref_losses = ranks
        # the big weights actually scattered over fsdp, the biases whole
        assert out[0]["plain"]["placements"] == {
            "fc1.weight": ["R", "S(0)", "R"], "fc1.bias": ["R", "R", "R"],
            "fc2.weight": ["R", "S(1)", "R"], "fc2.bias": ["R", "R", "R"]}
        losses = out[0]["plain"]["losses"]
        assert all(r["plain"]["losses"] == losses for r in out)
        np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-5)
        np.testing.assert_allclose(losses[1:3], ref_losses[1:3], rtol=1e-4)
        assert losses[-1] < losses[0] * 0.7, losses
        assert ref_losses[-1] < ref_losses[0] * 0.7, ref_losses

    def test_sharding_overrides(self, ranks):
        out, _ = ranks
        assert out[0]["overrides"]["placements"]["fc2.weight"] == ["R", "R", "R"]
        assert out[0]["overrides"]["placements"]["fc1.weight"] == ["R", "S(0)", "R"]


# the HF loaders: answers from the workload started with the module


@needs_transformers
def test_config_mapping(hf):
    module, got, want = hf["gpt_config"]
    assert module == "ray_tpu_torch.models.gpt" and got == want == [500, 128, 96, 3, 4, "float32"]
    module, got, want = hf["gptj_config"]
    assert module == "ray_tpu_torch.models.gptj" and got == want
    # HF's fallback for rotary_dim=None is the per-head dim: 96 / 4
    names = [f.name for f in dataclasses.fields(gptj.GPTJConfig)]
    assert got[names.index("rotary_dim")] == 24


@needs_transformers
def test_gpt2_forward_matches_reference_and_hf(hf):
    to_ref, to_hf = hf["gpt2_forward"]
    assert to_ref <= 1e-4 and to_hf <= 2e-3, (to_ref, to_hf)


@needs_transformers
def test_gpt2_vocab_padding(hf):
    vocab, embed, head, padded = hf["gpt2_padding"]
    assert vocab == 128 and embed == [128, 64] and head == [128, 64]  # nn.Linear's (out, in)
    assert padded == 0.0
    assert "cfg=" in hf["gpt2_no_cfg"]


@needs_transformers
def test_gptj_forward_matches_reference_and_hf(hf):
    to_ref, to_hf = hf["gptj_forward"]
    assert to_ref <= 1e-4 and to_hf <= 2e-3, (to_ref, to_hf)


@needs_transformers
def test_gptj_vocab_padding_blocks_padded_ids(hf):
    vocab, padded_max = hf["gptj_padding"]
    # -1e9 head bias on padded ids: argmax can never land there
    assert vocab == 128 and padded_max < -1e8


@needs_transformers
def test_gptj_decode_matches_reference_and_hf_greedy(hf):
    port, ref, hf_tokens = hf["gptj_decode"]
    assert port == ref == hf_tokens
