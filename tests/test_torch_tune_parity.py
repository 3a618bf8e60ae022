"""The port's seeded tune decisions equal the reference's: the same seed
gives the same variants (``BasicVariantGenerator``), the same suggestions
(TPE and random search, fed the same observations), the same scheduler
decisions (ASHA, the median rule, PBT's exploits and perturbations, PB2's
GP perturbations, fed the same results), and one ``Tuner`` run through
each package's own runtime, each in its own process, ends with the same
trial states, iterations and best config."""

import json
import math
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from ray_tpu import tune as ref
from ray_tpu.tune import pb2 as ref_pb2
from ray_tpu.tune import schedulers as ref_sched
from ray_tpu.tune import searcher as ref_searcher
from ray_tpu_torch import tune as port
from ray_tpu_torch.tune import pb2 as port_pb2
from ray_tpu_torch.tune import schedulers as port_sched
from ray_tpu_torch.tune import searcher as port_searcher

REPO = Path(__file__).resolve().parents[1]


def _space(t):
    """One search space in package ``t``'s domains: every domain kind,
    nested, with a grid."""
    return {
        "lr": t.loguniform(1e-5, 1e-1),
        "wd": t.uniform(0.0, 0.3),
        "q": t.quniform(0.0, 1.0, 0.125),
        "layers": t.randint(1, 9),
        "opt": {"name": t.choice(["adam", "sgd", "lion"]), "beta": t.grid_search([0.9, 0.99])},
        "const": 7,
    }


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_variants_equal_the_references(seed):
    want = ref.BasicVariantGenerator(seed=seed).generate(_space(ref), num_samples=5)
    got = port.BasicVariantGenerator(seed=seed).generate(_space(port), num_samples=5)
    assert len(got) == 10
    assert got == want


def _objective(cfg):
    return (math.log10(cfg["lr"]) + 3.0) ** 2 + cfg["wd"] + (0.0 if cfg["opt"]["name"] == "adam" else 0.5)


def _sequential_space(t):
    space = _space(t)
    space["opt"] = {"name": t.choice(["adam", "sgd", "lion"])}
    return space


@pytest.mark.parametrize("kind", ["tpe", "random"])
@pytest.mark.parametrize("mode", ["min", "max"])
def test_searcher_suggestions_equal_the_references(kind, mode):
    """Both searchers see the same stream of observations and must suggest
    the same configs, step for step (TPE's draws follow its observations)."""

    def make(mod, t):
        if kind == "tpe":
            s = mod.TPESearcher(metric="loss", mode=mode, n_initial=5, seed=3)
        else:
            s = mod.RandomSearcher(metric="loss", mode=mode, seed=3)
        s.set_search_properties("loss", mode, _sequential_space(t))
        return s

    a, b = make(ref_searcher, ref), make(port_searcher, port)
    for i in range(30):
        want, got = a.suggest(f"t{i}"), b.suggest(f"t{i}")
        assert got == want, i
        result = {"loss": _objective(want)}
        a.on_trial_complete(f"t{i}", result)
        b.on_trial_complete(f"t{i}", result)


def test_concurrency_limiter_equals_the_references():
    def make(mod, t):
        lim = mod.ConcurrencyLimiter(mod.TPESearcher(metric="loss", n_initial=2, seed=1), max_concurrent=2)
        lim.set_search_properties("loss", "min", {"x": t.uniform(-5, 5)})
        return lim

    a, b = make(ref_searcher, ref), make(port_searcher, port)
    stream = []
    for i in range(12):
        out = (a.suggest(f"t{i}"), b.suggest(f"t{i}"))
        stream.append(out)
        assert out[1] == out[0]
        if i % 3 == 2:
            for s in (a, b):
                s.on_trial_complete(f"t{i - 2}", {"loss": float(i)})
    assert [w is None for w, _ in stream].count(True) > 0  # the cap was met


class _Trial:
    """What a scheduler reads of a trial: an id, its config, a checkpoint."""

    def __init__(self, tid, config):
        self.id = tid
        self.config = dict(config)
        self.checkpoint = object()


def _results(n_trials, steps, seed):
    """A fixed stream of (trial index, iteration, metric) results, trials
    reporting in turns, some of them improving and some not."""
    rng = random.Random(seed)
    base = [rng.uniform(0.0, 10.0) for _ in range(n_trials)]
    slope = [rng.choice([0.0, 0.3, 1.0]) for _ in range(n_trials)]
    for t in range(1, steps + 1):
        for i in range(n_trials):
            yield i, t, base[i] - slope[i] * t + rng.gauss(0.0, 0.1)


def _drive(sched, trials, stream, metric="loss"):
    """Feed the stream; returns every decision, with the donor and the new
    config of each exploit, as the controller asks for them."""
    log = []
    stopped = set()
    for i, t, v in stream:
        if i in stopped:
            continue
        trial = trials[i]
        decision = sched.on_result(trial, {metric: v, "training_iteration": t})
        entry = [i, t, decision]
        if decision == "STOP":
            stopped.add(i)
        elif decision == "EXPLOIT":
            donor = sched.choose_exploit_source(trial, trials)
            entry.append(None if donor is None else donor.id)
            if donor is not None and hasattr(sched, "perturb_config"):
                trial.config = sched.perturb_config(dict(donor.config))
                entry.append(trial.config)
        log.append(entry)
    return log


def _pair(make_ref, make_port, n_trials=6, steps=12, seed=0, config=None):
    config = config or (lambda i: {"lr": 10 ** (-1 - i * 0.5), "mom": 0.9, "bs": 32 * (i + 1)})
    logs = []
    for make in (make_ref, make_port):
        trials = [_Trial(f"t{i}", config(i)) for i in range(n_trials)]
        logs.append(_drive(make(), trials, _results(n_trials, steps, seed)))
    return logs


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("rf", [2, 3])
def test_asha_decisions_equal_the_references(mode, rf):
    def make(mod):
        return lambda: mod.ASHAScheduler(metric="loss", mode=mode, grace_period=1, max_t=10,
                                         reduction_factor=rf)

    want, got = _pair(make(ref_sched), make(port_sched))
    assert got == want
    assert any(d == "STOP" for _, t, d in got if t < 10)  # it does stop early


@pytest.mark.parametrize("mode", ["min", "max"])
def test_median_rule_decisions_equal_the_references(mode):
    def make(mod):
        return lambda: mod.MedianStoppingRule(metric="loss", mode=mode, grace_period=2,
                                              min_samples_required=3)

    want, got = _pair(make(ref_sched), make(port_sched))
    assert got == want
    assert any(d == "STOP" for _, _, d in got)


@pytest.mark.parametrize("seed", [0, 7])
def test_pbt_exploits_and_perturbations_equal_the_references(seed):
    def make(mod, t):
        return lambda: mod.PopulationBasedTraining(
            metric="loss", mode="min", perturbation_interval=2, seed=seed,
            hyperparam_mutations={"lr": t.loguniform(1e-5, 1e-1), "mom": [0.8, 0.9, 0.99],
                                  "bs": t.randint(16, 256)},
        )

    want, got = _pair(make(ref_sched, ref), make(port_sched, port), seed=seed)
    assert got == want
    assert any(len(e) == 5 for e in got)  # an exploit that perturbed


@pytest.mark.parametrize("seed", [0, 3])
def test_pb2_perturbations_equal_the_references(seed):
    """PB2's GP-UCB explore step (numpy) gives the same configs: the
    fallback jitter first, then the GP once it has observations."""

    def make(mod):
        return lambda: mod.PB2(metric="loss", mode="min", perturbation_interval=2, seed=seed,
                               hyperparam_bounds={"lr": (1e-5, 1e-1), "mom": (0.8, 0.99)})

    want, got = _pair(make(ref_pb2), make(port_pb2), steps=16, seed=seed)
    assert got == want
    exploits = [e for e in got if len(e) == 5]
    assert len(exploits) > port_pb2._MIN_OBS_FOR_GP  # the GP's branch ran too


_TUNER_RUN = r"""
import json, sys, tempfile
pkg = sys.argv[1]
rt = __import__(pkg)
tune = __import__(pkg + ".tune", fromlist=["tune"])
train = __import__(pkg + ".train", fromlist=["train"])
rt.init(num_cpus=4, **({"num_gpus": 0} if pkg == "ray_tpu_torch" else {}))

def trainable(config):
    for i in range(1, 9):
        tune.report({"loss": (config["x"] - 0.3) ** 2 + config["y"] / i})

grid = tune.Tuner(
    trainable,
    param_space={"x": tune.uniform(-1.0, 1.0), "y": tune.choice([0.0, 1.0, 3.0])},
    tune_config=tune.TuneConfig(
        metric="loss", mode="min", num_samples=6, seed=11, max_concurrent_trials=1,
        scheduler=tune.ASHAScheduler(metric="loss", mode="min", grace_period=2, max_t=8,
                                     reduction_factor=2)),
    run_config=train.RunConfig(name="parity", storage_path=tempfile.mkdtemp()),
).fit()
state = json.load(open(grid[0].path.rsplit("/", 1)[0] + "/experiment_state.json"))
best = grid.get_best_result()
print(json.dumps({
    "states": [t["state"] for t in state["trials"]],
    "iterations": [t["iteration"] for t in state["trials"]],
    "metrics": [r.metrics and {k: r.metrics.get(k) for k in ("training_iteration", "loss")} for r in grid],
    "best": best.metrics["loss"],
    "best_config": [t["config"] for t in state["trials"] if t["last_result"].get("loss") == best.metrics["loss"]],
}))
rt.shutdown()
"""


def _tuner_run(pkg):
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _TUNER_RUN, pkg], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_tuner_run_ends_as_the_references():
    """Six seeded ASHA trials, one at a time so both runs see the results
    in one order: the same final states, iterations, metrics and best
    config."""
    want, got = _tuner_run("ray_tpu"), _tuner_run("ray_tpu_torch")
    assert got == want
    assert set(got["states"]) == {"TERMINATED"}
    assert min(got["iterations"]) < 8  # ASHA stopped one early
