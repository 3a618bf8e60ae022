"""The port stands alone: ray_tpu_torch and the chip scripts (chip_smoke.py,
chip_mutants.py, chip_flash_probe.py, chip_start_probe.py, chip_cuts.py, chip_mesh.py) import nothing of JAX or of the JAX package, and the port's entry points never fall back to
the CPU when the card is missing. No port file names a ``ray_tpu.`` module in
a string (the runtime spawns its workers and template by module name, which
an import scan cannot see), and a worker under ``ray_tpu_torch.init()`` loads
neither JAX nor the JAX package and runs the port's worker code."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ray_tpu"}


def _port_files():
    chip = ("chip_smoke.py", "chip_mutants.py", "chip_flash_probe.py", "chip_start_probe.py", "chip_cuts.py",
            "chip_mesh.py")
    return sorted((REPO / "ray_tpu_torch").rglob("*.py")) + [REPO / name for name in chip]


def _imported_top_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = [
        f"{p.relative_to(REPO)}:{line} imports {name}"
        for p in files
        for line, name in _imported_top_names(p)
        if name in FORBIDDEN
    ]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, ray_tpu_torch, ray_tpu_torch.llm.engine, ray_tpu_torch.ops._kernels\n"
        "import ray_tpu_torch.models.gpt, ray_tpu_torch.parallel\n"
        "import ray_tpu_torch.llm.watchdog, ray_tpu_torch.util.metrics, ray_tpu_torch.util.phases\n"
        "import ray_tpu_torch.util.tracing, ray_tpu_torch._private.events, ray_tpu_torch.exceptions\n"
        "import ray_tpu_torch._private.head, ray_tpu_torch._private.worker_main, ray_tpu_torch.actor\n"
        "import ray_tpu_torch._private.worker_template, ray_tpu_torch._private.node_agent\n"
        "import ray_tpu_torch.cluster_utils, ray_tpu_torch.dag.compiled, ray_tpu_torch.accelerators.gpu\n"
        "import ray_tpu_torch.experimental.channel, ray_tpu_torch.util.state, ray_tpu_torch._native\n"
        "import ray_tpu_torch.serve, ray_tpu_torch.serve.llm, ray_tpu_torch.serve._private.proxy\n"
        "import ray_tpu_torch.serve._private.grpc_proxy, ray_tpu_torch.serve._private.controller\n"
        "import ray_tpu_torch._private.chaos, ray_tpu_torch.obs, ray_tpu_torch.llm.loadgen\n"
        "import ray_tpu_torch.parallel.mesh, ray_tpu_torch.parallel.sharding, ray_tpu_torch.parallel.pipeline\n"
        "import ray_tpu_torch.parallel.multislice, ray_tpu_torch.parallel.fit_proof\n"
        "import ray_tpu_torch.parallel._multislice_worker, ray_tpu_torch.collective.collective\n"
        "import ray_tpu_torch.train.integrations.orbax, ray_tpu_torch.train.integrations.module_bridge\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_train_and_collective_load_no_jax_and_no_torch_until_asked():
    """``train`` and ``collective`` (which runtime workers import for every
    train worker and collective member) load neither JAX, the JAX package
    nor torch; ``train.integrations`` and ``models.gptj``'s loss bring torch
    and still no JAX."""
    code = (
        "import sys, ray_tpu_torch.train, ray_tpu_torch.collective\n"
        "import ray_tpu_torch.train._storage, ray_tpu_torch.train._checkpoint_manager\n"
        "import ray_tpu_torch.collective.coordinator, ray_tpu_torch.collective.types\n"
        "light = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu', 'torch'))\n"
        "import ray_tpu_torch.train.integrations, ray_tpu_torch.train.integrations.huggingface\n"
        "from ray_tpu_torch.models.gptj import gptj_loss, gptj_hidden\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(light, bad); sys.exit(1 if light or bad or 'torch' not in sys.modules else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_data_loads_no_jax_torch_or_pyarrow_until_asked():
    """``data`` loads neither JAX, the JAX package, torch, pyarrow nor pandas
    — not on import, not while a pipeline runs (reads, maps, a shuffle, the
    driver's batches), and not in the forked workers that run its tasks;
    ``iter_torch_batches`` brings torch, and still no JAX."""
    code = (
        "import sys, tempfile, os, numpy as np\n"
        "import ray_tpu_torch, ray_tpu_torch.data\n"
        "from ray_tpu_torch.data import (aggregate, block, context, dataset, datasource, datasource_ext,\n"
        "                                exchange, execution, iterator, plan)\n"
        "heavy = ('jax', 'jaxlib', 'ray_tpu', 'torch', 'pyarrow', 'pandas')\n"
        "loaded = lambda: sorted(m for m in sys.modules if m.split('.')[0] in heavy)\n"
        "after_import = loaded()\n"
        "d = tempfile.mkdtemp()\n"
        "[np.save(os.path.join(d, f'{i}.npy'), np.arange(40).reshape(10, 4) + i) for i in range(3)]\n"
        "ray_tpu_torch.init(num_cpus=2, num_gpus=0)\n"
        "rd = ray_tpu_torch.data\n"
        "probe = lambda b: {'mods': np.array([','.join(sorted(m for m in sys.modules\n"
        "                   if m.split('.')[0] in heavy))] * len(b['x']), dtype=object)}\n"
        "ds = rd.read_numpy(d, column='x').random_shuffle(seed=0)\n"
        "in_workers = sorted({r['mods'] for r in ds.map_batches(probe).take_all()})\n"
        "n = sum(len(b['x']) for b in ds.iter_batches(batch_size=7))\n"
        "after_run = loaded()\n"
        "t = next(iter(ds.iter_torch_batches(batch_size=7, device='cpu')))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu'))\n"
        "ray_tpu_torch.shutdown()\n"
        "print(after_import, in_workers, after_run, bad, n)\n"
        "sys.exit(1 if after_import or in_workers != [''] or after_run or bad or n != 30\n"
        "         or 'torch' not in sys.modules else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_tune_loads_no_jax_and_no_torch_until_asked():
    """``tune`` loads neither JAX, the JAX package nor torch — not on import,
    not while a Tuner runs its trials, and not in the trial workers — until
    a trainable imports torch, which then loads in its worker only."""
    code = (
        "import sys, tempfile\n"
        "import ray_tpu_torch, ray_tpu_torch.tune\n"
        "from ray_tpu_torch.tune import controller, optuna_adapter, pb2, registry, schedulers, search, searcher\n"
        "from ray_tpu_torch import tune\n"
        "heavy = ('jax', 'jaxlib', 'ray_tpu', 'torch')\n"
        "loaded = lambda: sorted(m for m in sys.modules if m.split('.')[0] in heavy)\n"
        "after_import = loaded()\n"
        "ray_tpu_torch.init(num_cpus=2, num_gpus=0)\n"
        "def light(config):\n"
        "    tune.report({'mods': ','.join(loaded()), 'x': config['x']})\n"
        "def heavy_trainable(config):\n"
        "    import torch\n"
        "    tune.report({'mods': ','.join(loaded()), 'x': config['x']})\n"
        "runs = {}\n"
        "for fn in (light, heavy_trainable):\n"
        "    grid = tune.Tuner(fn, param_space={'x': tune.grid_search([1, 2])},\n"
        "                      run_config=tune.RunConfig(storage_path=tempfile.mkdtemp())).fit()\n"
        "    runs[fn.__name__] = sorted({r.metrics['mods'] for r in grid})\n"
        "after_run = loaded()\n"
        "ray_tpu_torch.shutdown()\n"
        "print(after_import, runs, after_run)\n"
        "sys.exit(1 if after_import or after_run or runs['light'] != ['']\n"
        "         or 'torch' not in runs['heavy_trainable'][0].split(',') else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_rl_and_rlhf_load_no_jax_and_no_torch_until_asked():
    """``rl`` and ``rlhf`` load neither JAX, the JAX package nor torch — not
    on import of any of their modules but ``rl.rl_module``, not when
    ``tune`` resolves every RL algorithm name through them, and not in a
    runtime worker that receives the rollout worker, env runner, learner and
    algorithm classes (as the
    runtime does before an actor's ``__init__`` opens torch and the card);
    ``rl.ActorCriticModule`` brings torch, and still no JAX."""
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.rl, ray_tpu_torch.rlhf\n"
        "from ray_tpu_torch.rl import (algorithm, connectors, env, env_runner, learner, multi_agent,\n"
        "                              offline, replay_buffer, sample_batch, spaces)\n"
        "from ray_tpu_torch.rl.algorithms import appo, bc, cql, ddpg, dqn, dreamer, es, impala, ppo\n"
        "from ray_tpu_torch.rl.algorithms import sac, td3\n"
        "from ray_tpu_torch.rlhf import algorithm, buffer, learner, metrics, rollout, smoke, sync\n"
        "from ray_tpu_torch import tune\n"
        "heavy = ('jax', 'jaxlib', 'ray_tpu', 'torch')\n"
        "loaded = lambda: sorted(m for m in sys.modules if m.split('.')[0] in heavy)\n"
        "ppo_trainable = tune.resolve_trainable('PPO')\n"
        "trainables = [tune.resolve_trainable(n).__name__ for n in sorted(tune.registry.RL_ALGORITHMS)]\n"
        "after_import = loaded()\n"
        "ray_tpu_torch.init(num_cpus=2, num_gpus=0)\n"
        "@ray_tpu_torch.remote\n"
        "def receive(*classes):\n"
        "    return ','.join(loaded())\n"
        "in_worker = ray_tpu_torch.get(receive.remote(rollout.RolloutWorker, env_runner.EnvRunner,\n"
        "                                             learner.LearnerGroup, ppo.PPO, dqn.DQN, sac.SAC,\n"
        "                                             impala.IMPALA, es.ES, dreamer.Dreamer), timeout=60)\n"
        "ray_tpu_torch.shutdown()\n"
        "module = ray_tpu_torch.rl.ActorCriticModule\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu'))\n"
        "print(after_import, repr(in_worker), bad)\n"
        "sys.exit(1 if after_import or in_worker or bad or 'torch' not in sys.modules\n"
        "         or ppo_trainable.__name__ != 'PPO' or len(trainables) != 12 else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_operator_tooling_loads_no_jax_and_no_torch():
    """``obs``, ``job``, ``dashboard`` and the ``util`` modules of the
    operator tooling load neither JAX, the JAX package nor torch — on
    import, and when ``python -m ray_tpu_torch.obs`` parses its commands
    and renders — so attaching an operator's tool costs no torch import."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.obs, ray_tpu_torch.job, ray_tpu_torch.dashboard\n"
        "from ray_tpu_torch.util import (actor_pool, check_serialize, device_prof, grafana,\n"
        "                                multiprocessing, otlp, pubsub, queue)\n"
        "import ray_tpu_torch.util as util\n"
        "util.ActorPool, util.Queue, grafana.dashboard_json(), otlp.export(events=[{'ts': 1.0, 'type': 'x'}])\n"
        "device_prof.JitProfiler().note('site', print, 1e-3)\n"
        "ray_tpu_torch.obs.render_arena({}), ray_tpu_torch.obs.measure_overhead(n=10)\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu', 'torch'))\n"
        "print(heavy); sys.exit(1 if heavy else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch.obs", "--help"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "waterfall" in proc.stdout, proc.stdout + proc.stderr


def test_autoscaler_and_cli_load_no_jax_and_no_torch():
    """``autoscaler`` (every module), ``scripts`` and the ``__main__``
    module load neither JAX, the JAX package nor torch, on import and when
    the CLI runs a command (``grafana``): ``status`` and ``summary`` pay no
    torch import."""
    code = (
        "import os, runpy, sys, tempfile\n"
        "import ray_tpu_torch.autoscaler, ray_tpu_torch.scripts\n"
        "from ray_tpu_torch.autoscaler import autoscaler, cluster_config, gce, gke, node_provider, v2\n"
        "out = os.path.join(tempfile.mkdtemp(), 'board.json')\n"
        "sys.argv = ['ray_tpu_torch', 'grafana', '-o', out]\n"
        "try:\n"
        "    runpy.run_module('ray_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0 and os.path.getsize(out) > 0, e.code\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu', 'torch'))\n"
        "print(heavy); sys.exit(1 if heavy else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "--help"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "node-stats" in proc.stdout, proc.stdout + proc.stderr


def test_workflow_loads_no_jax_and_no_torch():
    """``workflow`` and ``workflow.virtual_actor`` load neither JAX, the JAX
    package nor torch — on import, and when a driver runs a workflow with a
    checkpointed step, an event and a virtual actor's transaction."""
    code = (
        "import sys, tempfile\n"
        "import ray_tpu_torch\n"
        "from ray_tpu_torch import workflow\n"
        "import ray_tpu_torch.workflow.virtual_actor\n"
        "ray_tpu_torch.init(num_cpus=2, num_gpus=0)\n"
        "storage = tempfile.mkdtemp()\n"
        "add = ray_tpu_torch.remote(lambda a, b: a + b)\n"
        "workflow.send_event('w', 'go', 2, storage=storage)\n"
        "assert workflow.run(add.bind(40, workflow.wait_for_event('go')), workflow_id='w', storage=storage) == 42\n"
        "class Box:\n"
        "    def __init__(self):\n"
        "        self.v = 0\n"
        "    def put(self, v):\n"
        "        self.v = v\n"
        "        return v\n"
        "assert workflow.virtual_actor(Box).get_or_create('b', storage=storage).put(7) == 7\n"
        "ray_tpu_torch.shutdown()\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu', 'torch'))\n"
        "print(heavy); sys.exit(1 if heavy else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", ["workflow", "workflow.virtual_actor"])
def test_workflow_exports_the_reference_names(name):
    """The port's workflow modules define the reference's public names (the
    modules they import aside)."""
    import importlib
    import inspect

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_") and not inspect.ismodule(getattr(mod, n))}

    ref = public(importlib.import_module(f"ray_tpu.{name}"))
    port = public(importlib.import_module(f"ray_tpu_torch.{name}"))
    assert port == ref
    assert {"run", "resume", "virtual_actor", "readonly", "get_actor"} & ref


def test_building_and_serving_a_model_imports_no_dynamo():
    """A fresh process that builds GPT, GPT-J and an RL module, serves from
    the paged engine and runs a forward without grad never imports
    ``torch._dynamo`` or sympy (seconds of a GPU worker's start): modules
    built on the meta device are materialized without ``to_empty``, the
    embeddings skip their own init draw, and a block runs unchecked when
    there is no backward."""
    code = (
        "import sys, torch\n"
        "from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams\n"
        "from ray_tpu_torch.models.gpt import GPTConfig, gpt_forward, gpt_init\n"
        "from ray_tpu_torch.models.gptj import GPTJConfig, gptj_init\n"
        "cfg = GPTConfig(vocab_size=128, seq_len=64, d_model=64, n_layers=2, n_heads=1, dtype='float32')\n"
        "p = gpt_init(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "gptj_init(GPTJConfig(vocab_size=64, d_model=16, n_layers=1, n_heads=2, rotary_dim=4), torch.Generator(), 'cpu')\n"
        "eng = LLMEngine(cfg, p, EngineConfig(max_slots=2, num_blocks=16, block_size=4, max_blocks_per_seq=8,\n"
        "                                     prefill_chunk=8), device='cpu')\n"
        "eng.warmup(); eng.generate([1, 2, 3], SamplingParams(max_tokens=3, temperature=0.0))\n"
        "with torch.no_grad():\n"
        "    gpt_forward(cfg, p, torch.zeros(1, 8, dtype=torch.long))\n"
        "assert cfg.remat and p.embed.weight.requires_grad\n"
        "from ray_tpu_torch.rl.rl_module import ActorCriticModule, RLModuleSpec\n"
        "from ray_tpu_torch.rl.spaces import Box, Discrete\n"
        "ActorCriticModule(RLModuleSpec(Box(-1, 1, shape=(4,)), Discrete(2))).init(torch.Generator(), 'cpu')\n"
        "loaded = sorted(m for m in sys.modules if m.startswith(('torch._dynamo', 'sympy')))\n"
        "print(loaded[:5]); sys.exit(1 if loaded else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_rl_and_rlhf_entry_points_without_device_need_cuda(monkeypatch):
    """A learner, an env runner, an RL module and a rollout worker with no
    device mean the card: without a GPU they raise, never sampling or
    learning on the CPU quietly."""
    from ray_tpu_torch.models.gpt import GPTConfig
    from ray_tpu_torch.rl import EnvRunner, Learner
    from ray_tpu_torch.rl.algorithms.ppo import ppo_loss
    from ray_tpu_torch.rl.rl_module import ActorCriticModule, RLModuleSpec
    from ray_tpu_torch.rl.spaces import Box, Discrete
    from ray_tpu_torch.rlhf import RolloutWorker

    spec = RLModuleSpec(Box(-1, 1, shape=(4,)), Discrete(2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Learner(lambda: ActorCriticModule(spec), ppo_loss(0.2, 10.0, 0.5, 0.0)),
                 lambda: EnvRunner("CartPole-v1"),
                 lambda: ActorCriticModule(spec).init(torch.Generator()),
                 lambda: RolloutWorker(model_cfg=GPTConfig(vocab_size=16, seq_len=8, d_model=8,
                                                           n_layers=1, n_heads=2), warmup=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_gpu_trial_without_a_gpu_raises_at_once():
    """A trial that asks for a GPU share on a cluster with no GPU makes the
    Tuner raise at once: no trial is left pending, none runs on the CPU."""
    code = (
        "import sys, tempfile, time\n"
        "import ray_tpu_torch\n"
        "from ray_tpu_torch import tune\n"
        "ray_tpu_torch.init(num_cpus=2, num_gpus=0)\n"
        "ran = tempfile.mkdtemp()\n"
        "def trainable(config):\n"
        "    open(ran + '/ran', 'w').close()\n"
        "    tune.report({'x': 1})\n"
        "t0 = time.monotonic()\n"
        "try:\n"
        "    tune.Tuner(tune.with_resources(trainable, {'CPU': 1, 'GPU': 0.5}),\n"
        "               run_config=tune.RunConfig(storage_path=tempfile.mkdtemp())).fit()\n"
        "    err = None\n"
        "except RuntimeError as e:\n"
        "    err = str(e)\n"
        "took = time.monotonic() - t0\n"
        "import os\n"
        "ran_any = os.path.exists(ran + '/ran')\n"
        "ray_tpu_torch.shutdown()\n"
        "print(err, took, ran_any)\n"
        "sys.exit(0 if err and 'no node of this cluster has a GPU' in err and took < 10 and not ran_any else 1)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_sends_its_runtime_code_by_value():
    """On the card ``chip_smoke.py`` runs as ``__main__``, so the functions
    and classes it hands the runtime's workers (phase 23's GPU task, phase
    25's train loop and collective member, phase 28's trainable and train
    loop, phase 29's rollout worker and reward, phase 32's actor, phase
    33's workflow steps and virtual actor) travel by cloudpickle's value
    path, which must be able to carry every global they name."""
    code = (
        "import sys, cloudpickle\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke as cs\n"
        "cloudpickle.register_pickle_by_value(cs)\n"
        "for obj in (cs.train_loop_406m, cs.CollectiveMember, cs.k1_in_a_gpu_task, cs.GPTEngineHost,\n"
        "            cs.gpt_124m_trainable, cs.gpt_124m_train_loop, cs.CardRolloutWorker, cs.low_id_reward,\n"
        "            cs.CLIEngineHost, cs.wf_prompts, cs.wf_generate, cs.wf_score, cs.wf_summarize,\n"
        "            cs.wf_finish, cs.RunLedger, cs.wf_dag()):\n"
        "    cloudpickle.dumps(obj)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_engine_without_device_needs_cuda(monkeypatch):
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models.gptj import GPTJConfig, gptj_init, params_from_jax

    cfg = GPTJConfig(vocab_size=16, d_model=8, n_layers=1, n_heads=2, rotary_dim=2, dtype="float32")
    params = gptj_init(cfg, torch.Generator().manual_seed(0), "cpu")
    # the reference's tree layout: stacked L axis, kernels (in, out)
    tree = {
        "embed": {"tokens": params.embed.weight.numpy()},
        "blocks": {
            "ln1": {"scale": params.blocks[0].ln1.scale[None].numpy(),
                    "bias": params.blocks[0].ln1.bias[None].numpy()},
            **{n: {"kernel": getattr(params.blocks[0], n).weight.T[None].numpy()}
               for n in ("q", "k", "v", "attn_out")},
            **{n: {"kernel": getattr(params.blocks[0], n).weight.T[None].numpy(),
                   "bias": getattr(params.blocks[0], n).bias[None].numpy()}
               for n in ("mlp_in", "mlp_out")},
        },
        "ln_f": {"scale": params.ln_f.scale.numpy(), "bias": params.ln_f.bias.numpy()},
        "lm_head": {"kernel": params.lm_head.weight.T.numpy(), "bias": params.lm_head.bias.numpy()},
    }
    if not torch.cuda.is_available():
        for make in (lambda: LLMEngine(cfg, params),
                     lambda: gptj_init(cfg, torch.Generator()),
                     lambda: params_from_jax(tree, cfg)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(cfg, params, device="cuda:0")
    # a speculating engine is ported: it too needs the card, and says so
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(cfg, params, EngineConfig(spec_k=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gptj_init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree, cfg)
    assert LLMEngine(cfg, params, device="cpu").device == torch.device("cpu")
    # asked for the CPU, both entry points build real weights there
    again = params_from_jax(tree, cfg, "cpu")
    for (name, a), b in zip(params.named_parameters(), again.parameters()):
        assert b.device.type == "cpu" and torch.equal(a, b), name


def test_kv_block_pool_without_device_needs_cuda(monkeypatch):
    """``KVBlockPool``, exported from ``llm``, means the card without a
    device, as every entry point does: without a GPU it raises, and it is
    built on the CPU only when asked."""
    from ray_tpu_torch.llm import CacheConfig, KVBlockPool

    cfg = CacheConfig(num_blocks=4, block_size=2, max_blocks_per_seq=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVBlockPool(cfg, n_layers=1, n_heads=1, head_dim=4)
    pool = KVBlockPool(cfg, n_layers=1, n_heads=1, head_dim=4, device="cpu")
    assert pool.k.device.type == "cpu" and pool.v.device.type == "cpu"


def test_gptj_init_refuses_a_generator_on_another_device(monkeypatch):
    """A CPU generator for a model on the card is refused before anything
    is allocated (the card itself is faked: the check comes first)."""
    from ray_tpu_torch.models.gptj import GPTJConfig, gptj_init

    cfg = GPTJConfig(vocab_size=16, d_model=8, n_layers=1, n_heads=2, rotary_dim=2, dtype="float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="generator is on cpu"):
        gptj_init(cfg, torch.Generator().manual_seed(0))


def test_spec_engine_on_the_card_refuses_windows_the_kernel_lacks(monkeypatch):
    """The verify kernel takes its window at run time, so on the card no
    spec_k is refused for its window: spec_k = 15 (a window of 16, past the
    first kernel's widest of 8) and 16 (past one 16-row query tile) pass the
    window checks and stop only at the CPU weights (the card is faked: the
    device check comes before anything is allocated). The CPU path takes
    them too."""
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models.gptj import GPTJConfig, gptj_init

    cfg = GPTJConfig(vocab_size=16, d_model=8, n_layers=1, n_heads=2, rotary_dim=2, dtype="float32")
    params = gptj_init(cfg, torch.Generator().manual_seed(0), "cpu")
    for k in (15, 16):
        assert LLMEngine(cfg, params, EngineConfig(spec_k=k), device="cpu")._drafter is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for k in (15, 16):
        with pytest.raises(ValueError, match="params are on cpu"):
            LLMEngine(cfg, params, EngineConfig(spec_k=k))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from ray_tpu_torch.ops import _kernels

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.nvcc_path()


def test_training_entry_points_without_device_need_cuda(monkeypatch):
    from ray_tpu_torch.models.gpt import GPTConfig, gpt_init
    from ray_tpu_torch.parallel import adamw, build_train_step

    cfg = GPTConfig(vocab_size=16, seq_len=8, d_model=8, n_layers=1, n_heads=2, dtype="float32")
    params = gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    init_fn, _ = build_train_step(lambda p, t: p.embed.weight.sum(), adamw(1e-4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt_init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_fn(params)
    state = init_fn(params, "cpu")
    assert state.step == 0 and all(p.device.type == "cpu" for p in state.params.parameters())


def test_make_mesh_without_device_needs_cuda():
    """``make_mesh()`` with no device means the card: without one it raises
    and starts no process group (never a CPU group in its place); the same
    for ``mesh_allreduce`` of a host array. In a fresh process, so no group
    could outlive the test."""
    code = (
        "import sys, torch, torch.distributed as dist\n"
        "torch.cuda.is_available = lambda: False\n"
        "from ray_tpu_torch.parallel import make_mesh\n"
        "from ray_tpu_torch.collective import mesh_allreduce\n"
        "for call in (make_mesh, lambda: mesh_allreduce([1.0, 2.0])):\n"
        "    try:\n"
        "        call()\n"
        "        sys.exit('no error')\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    assert not dist.is_initialized()\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_iter_torch_batches_without_device_needs_cuda(monkeypatch):
    """``iter_torch_batches()`` with no device means the card, as
    ``jax.device_put``'s default device does on the reference: without a GPU
    it raises at the call, before any data moves."""
    from ray_tpu_torch import data as rd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = rd.range(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.iter_torch_batches(batch_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.iterator().iter_torch_batches(batch_size=4, device="cuda")


def test_flash_on_a_card_raises_for_a_head_dim_the_kernels_lack(monkeypatch):
    """Tensors that say they are on the card take the kernel path: a head dim
    of 256 raises there and never falls back to the plain version."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops.attention import causal_attention

    q = torch.zeros(1, 2, 16, 256)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for run in (lambda: fa.flash_attention(q, q, q), lambda: causal_attention(q, q, q),
                lambda: causal_attention(q, q, q, impl="flash")):
        with pytest.raises(ValueError, match="head_dim in"):
            run()
    assert fa.flash_fwd_cuda.launches == 0


def test_engine_refuses_the_training_gpt():
    """The engine serves the dense GPT (capped at its positional table) and
    refuses a mixture-of-experts one, as the reference's runner does."""
    import dataclasses

    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.models.gpt import GPTConfig, gpt_init

    cfg = GPTConfig(vocab_size=16, seq_len=8, d_model=8, n_layers=1, n_heads=2, dtype="float32")
    params = gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert LLMEngine(cfg, params, device="cpu").max_model_len == cfg.seq_len
    with pytest.raises(NotImplementedError, match="dense GPT only"):
        LLMEngine(dataclasses.replace(cfg, n_experts=4), params, device="cpu")


def _docstring_nodes(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                yield body[0].value


def test_no_port_string_names_a_jax_package_module():
    """Seam of the runtime's copy: workers and the forkserver template are
    started by module name (``python -m <package>._private.worker_main``), a
    string the import scan above cannot see. A string naming a ``ray_tpu.``
    module would run the JAX package's workers under the port's head."""
    pattern = re.compile(r"\bray_tpu\.[A-Za-z_]")
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        docs = {id(node) for node in _docstring_nodes(tree)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs and pattern.search(node.value)):
                bad.append(f"{path.relative_to(REPO)}:{node.lineno}: {node.value[:80]!r}")
    assert bad == []
    # the spawn names themselves point into the port
    head = (REPO / "ray_tpu_torch/_private/head.py").read_text()
    agent = (REPO / "ray_tpu_torch/_private/node_agent.py").read_text()
    handles = (REPO / "ray_tpu_torch/_private/proc_handles.py").read_text()
    assert '"ray_tpu_torch._private.worker_main"' in head
    assert '"ray_tpu_torch._private.worker_main"' in agent
    assert '"ray_tpu_torch._private.worker_template"' in handles


_WORKER_PROBE = """
import os, sys

import ray_tpu_torch

ray_tpu_torch.init(num_cpus=1, _system_config={"worker_forkserver_enabled": %(forked)s})

@ray_tpu_torch.remote
def probe():
    import os, sys
    with open(f"/proc/{os.getpid()}/cmdline", "rb") as f:
        argv = f.read().replace(b"\\0", b" ").decode()
    mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "torch"))
    return argv, mods, os.getpid()

argv, mods, pid = ray_tpu_torch.get(probe.remote(), timeout=60)
ray_tpu_torch.shutdown()
print(repr((argv, mods, pid != os.getpid())))
"""


@pytest.mark.parametrize("forked", [True, False], ids=["forked", "cold"])
def test_runtime_workers_run_the_port(forked):
    """A task under ``ray_tpu_torch.init()`` runs in a worker whose argv names
    ``ray_tpu_torch`` (the forkserver template's, or a cold-spawned worker's
    own) and whose modules hold neither JAX, the JAX package nor torch (the
    template imports none, so a forked worker can still open the card)."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", _WORKER_PROBE % {"forked": forked}], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    argv, mods, other_process = eval(proc.stdout.strip().splitlines()[-1])
    assert other_process
    assert mods == []
    entry = "ray_tpu_torch._private.worker_template" if forked else "ray_tpu_torch._private.worker_main"
    assert f"-m {entry} " in argv, argv
    assert "ray_tpu." not in argv.replace("ray_tpu_torch.", "")
