"""One training workload through both packages' trainers:
``ray_tpu.train.JaxTrainer`` and ``ray_tpu_torch.train.TorchTrainer``, each
in a fresh process of its own with its own runtime.

The same train loop (per package: its ``build_train_step`` with AdamW at
lr 1e-3 and optax's defaults, its checkpoints) trains a narrow fp32 GPT (2
layers, d 64, 2 heads, vocab 128, seq 32, remat "full") from the same
weights — the reference's ``gpt_init``, carried into the port by
``params_from_jax`` — on the same numpy token batches, fed through
``get_dataset_shard("train")``. It runs twice: uninterrupted for 6 steps,
and with ``FailureConfig(max_failures=1)`` where the first attempt's worker
checkpoints at step 3 and calls ``os._exit(1)`` right after reporting step
4; the group restarts from step 3's checkpoint and runs steps 4-5 again.
(Steps count from 0, as in ``chip_smoke.py`` phase 25.)

Tolerance: every per-step loss within rtol 1e-5 of the reference's (the
bound of ``tests/test_torch_train_step.py``: both are fp32, summation order
only), in both runs, and the resumed steps equal the uninterrupted run's
within each package (bit for bit in the port, whose checkpoint holds the
optimizer state exactly).
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from ray_tpu.models import gpt as ref_gpt

REPO = Path(__file__).resolve().parents[1]
SHAPE = dict(vocab_size=128, seq_len=32, d_model=64, n_layers=2, n_heads=2, dtype="float32")
STEPS, CKPT_AT, DIE_AFTER = 6, 3, 4
RTOL = 1e-5

WORKLOAD = r'''
import importlib, json, os, pickle, sys, tempfile

pkg, weights_path, storage = sys.argv[1], sys.argv[2], sys.argv[3]
rt = importlib.import_module(pkg)
train = importlib.import_module(pkg + ".train")
if pkg == "ray_tpu":
    rt.init(num_cpus=2, num_tpus=0)
    Trainer = train.JaxTrainer
else:
    rt.init(num_cpus=2, num_gpus=0)
    Trainer = train.TorchTrainer
with open(weights_path, "rb") as f:
    setup = pickle.load(f)


def loop(config):
    import os, tempfile

    import numpy as np

    pkg = config["pkg"]
    train = importlib.import_module(pkg + ".train")
    start = 0
    if pkg == "ray_tpu":
        import jax
        import jax.numpy as jnp
        import optax

        from ray_tpu.models import gpt
        from ray_tpu.parallel.mesh import MeshConfig, make_mesh
        from ray_tpu.parallel.train_step import build_train_step

        cfg = gpt.GPTConfig(**config["shape"])
        mesh = make_mesh(MeshConfig(dp=1, fsdp=1, tp=1, sp=1), devices=[jax.devices()[0]])
        init_fn, step_fn = build_train_step(lambda p, t: gpt.gpt_loss(cfg, p, t, mesh),
                                            optax.adamw(config["lr"]), mesh)
        state = init_fn(jax.tree.map(jnp.asarray, config["tree"]))
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            saved = train.load_pytree(ckpt)
            state = jax.tree.map(lambda a, s: jax.device_put(a, s.sharding), saved, state)
            start = int(ckpt.get_metadata()["step"])

        def step(state, batch):
            state, loss = step_fn(state, jnp.asarray(batch))
            return state, float(loss)

        def save(state, d, i):
            return train.save_pytree(state, d, step=i)
    else:
        import torch

        from ray_tpu_torch.models import gpt
        from ray_tpu_torch.parallel import adamw, build_train_step

        torch.set_num_threads(2)
        cfg = gpt.GPTConfig(**config["shape"])
        init_fn, step_fn = build_train_step(lambda p, t: gpt.gpt_loss(cfg, p, t), adamw(config["lr"]))
        state = init_fn(gpt.params_from_jax(config["tree"], cfg, "cpu"), "cpu")
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            state = train.load_state(ckpt, state)
            start = state.step

        def step(state, batch):
            state, loss = step_fn(state, torch.from_numpy(batch))
            return state, loss.item()

        def save(state, d, i):
            return train.save_state(state, d)

    for i, batch in enumerate(train.get_dataset_shard("train")):
        if i < start:
            continue
        state, loss = step(state, batch)
        # the state after step i has taken i + 1 steps
        ckpt = save(state, tempfile.mkdtemp(), i + 1) if i == config["ckpt_at"] else None
        train.report({"step": i, "loss": loss, "resumed_from": start}, checkpoint=ckpt)
        if config["die_after"] == i and start == 0:
            os._exit(1)  # a real process death, right after reporting this step


out = {}
for run, die_after in (("plain", -1), ("failed", setup["die_after"])):
    result = Trainer(
        loop,
        train_loop_config=dict(pkg=pkg, shape=setup["shape"], tree=setup["tree"], lr=setup["lr"],
                               ckpt_at=setup["ckpt_at"], die_after=die_after),
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(name=run, storage_path=storage, verbose=0,
                                   failure_config=train.FailureConfig(max_failures=1)),
        datasets={"train": setup["batches"]},
    ).fit()
    out[run] = {
        "error": None if result.error is None else repr(result.error),
        "history": [h["metrics"] for h in result.metrics_history],
        "checkpoint_step": result.checkpoint.get_metadata().get("step") if result.checkpoint else None,
    }
rt.shutdown()
print("RESULT " + json.dumps(out))
'''


def _start(package: str, weights: Path, storage: Path) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen([sys.executable, "-c", WORKLOAD, package, str(weights), str(storage)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc: subprocess.Popen) -> dict:
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-4000:] + err[-4000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    cfg = ref_gpt.GPTConfig(**SHAPE)
    tree = jax.device_get(ref_gpt.gpt_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(7)
    batches = [rng.randint(0, SHAPE["vocab_size"], (4, SHAPE["seq_len"] + 1)).astype(np.int32)
               for _ in range(STEPS)]
    weights = tmp / "setup.pkl"
    with open(weights, "wb") as f:
        pickle.dump(dict(shape=SHAPE, tree=tree, batches=batches, lr=1e-3, ckpt_at=CKPT_AT,
                         die_after=DIE_AFTER), f)
    # the two packages' runs side by side, each in its own process
    procs = {pkg: _start(pkg, weights, tmp / pkg) for pkg in ("ray_tpu", "ray_tpu_torch")}
    return {pkg: _result(proc) for pkg, proc in procs.items()}


def _losses(history, resumed: bool):
    """step -> loss of the reports of one attempt (the first, or the
    resumed one)."""
    return {m["step"]: m["loss"] for m in history if (m["resumed_from"] > 0) == resumed}


@pytest.mark.parametrize("package", ["ray_tpu", "ray_tpu_torch"])
def test_each_run_trained_as_asked(results, package):
    plain, failed = results[package]["plain"], results[package]["failed"]
    assert plain["error"] is None and failed["error"] is None
    assert [m["step"] for m in plain["history"]] == list(range(STEPS))
    # the first attempt reported steps 0-4, the group restarted from step
    # 3's checkpoint (a state 4 steps in) and reported steps 4-5 again
    assert [(m["step"], m["resumed_from"]) for m in failed["history"]] == (
        [(i, 0) for i in range(DIE_AFTER + 1)] + [(i, CKPT_AT + 1) for i in range(CKPT_AT + 1, STEPS)])
    assert plain["checkpoint_step"] == failed["checkpoint_step"] == CKPT_AT + 1
    assert all(np.isfinite(m["loss"]) for m in plain["history"] + failed["history"])


def test_uninterrupted_losses_match_the_reference(results):
    ref = _losses(results["ray_tpu"]["plain"]["history"], False)
    port = _losses(results["ray_tpu_torch"]["plain"]["history"], False)
    assert sorted(port) == sorted(ref) == list(range(STEPS))
    np.testing.assert_allclose([port[i] for i in range(STEPS)], [ref[i] for i in range(STEPS)],
                               rtol=RTOL)


def test_losses_after_a_worker_failure_match_the_reference(results):
    for resumed in (False, True):
        ref = _losses(results["ray_tpu"]["failed"]["history"], resumed)
        port = _losses(results["ray_tpu_torch"]["failed"]["history"], resumed)
        assert sorted(port) == sorted(ref)
        np.testing.assert_allclose([port[i] for i in sorted(port)], [ref[i] for i in sorted(ref)],
                                   rtol=RTOL)


@pytest.mark.parametrize("package", ["ray_tpu", "ray_tpu_torch"])
def test_resumed_steps_equal_the_uninterrupted_run(results, package):
    plain = _losses(results[package]["plain"]["history"], False)
    resumed = _losses(results[package]["failed"]["history"], True)
    assert sorted(resumed) == list(range(CKPT_AT + 1, STEPS))
    got = [resumed[i] for i in sorted(resumed)]
    want = [plain[i] for i in sorted(resumed)]
    if package == "ray_tpu_torch":
        assert got == want  # the checkpoint holds the optimizer state exactly
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL)
