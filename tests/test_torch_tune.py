"""The port's Tune against the reference's tests: a mirror of
``tests/test_tune.py`` run on ``ray_tpu_torch.tune`` (variant generation,
trial execution, ASHA early stopping, PBT exploit/explore, checkpoint
resume, failure retries, experiment state, a trainer as a trainable), plus
what the port adds: trials holding fractional GPU shares of one card, a
GPU trainer inside a trial, and the registry's refusal of RL names. The
runtime is shared by the module; its node offers one logical ``GPU`` and
lists the card ``3`` (nothing here touches CUDA)."""

import os
import signal
import threading

import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.train import Checkpoint, FailureConfig, RunConfig

#: the longest a test that waits for trials may take
TRIALS_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def _shared_cluster():
    mp = pytest.MonkeyPatch()
    mp.setenv("CUDA_VISIBLE_DEVICES", "3")  # the node's card; workers inherit the list
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    yield
    ray_tpu_torch.shutdown()
    mp.undo()


@pytest.fixture
def ray_start_regular(_shared_cluster):
    """The cluster, and a time limit: a test that waits for trials fails
    with TimeoutError past ``TRIALS_TIMEOUT_S`` rather than hold its worker."""
    if threading.current_thread() is not threading.main_thread():
        yield  # signals reach the main thread only
        return

    def expire(signum, frame):
        raise TimeoutError(f"trials still running after {TRIALS_TIMEOUT_S} s")

    before = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TRIALS_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, before)


@pytest.fixture
def storage(tmp_path):
    return str(tmp_path / "tune_results")


def test_variant_generation():
    gen = tune.BasicVariantGenerator(seed=0)
    cfgs = gen.generate(
        {"lr": tune.grid_search([0.1, 0.2]), "wd": tune.uniform(0, 1), "c": 5},
        num_samples=3,
    )
    assert len(cfgs) == 6
    assert {c["lr"] for c in cfgs} == {0.1, 0.2}
    assert all(0 <= c["wd"] <= 1 and c["c"] == 5 for c in cfgs)


def test_nested_space_and_choice():
    gen = tune.BasicVariantGenerator(seed=1)
    cfgs = gen.generate({"opt": {"lr": tune.choice([1, 2]), "name": "adam"}}, num_samples=4)
    assert len(cfgs) == 4
    assert all(c["opt"]["lr"] in (1, 2) and c["opt"]["name"] == "adam" for c in cfgs)


def test_basic_tune_run(ray_start_regular, storage):
    def trainable(config):
        score = (config["x"] - 3) ** 2
        tune.report({"score": score})

    grid = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([0, 1, 2, 3, 4])},
        tune_config=tune.TuneConfig(metric="score", mode="min"),
        run_config=RunConfig(name="basic", storage_path=storage),
    ).fit()
    assert len(grid) == 5
    best = grid.get_best_result()
    assert best.metrics["score"] == 0


def test_asha_early_stops(ray_start_regular, storage):
    def trainable(config):
        for i in range(8):
            # bad configs plateau high; good ones descend
            loss = config["base"] - i * 0.5 if config["base"] < 5 else config["base"]
            tune.report({"loss": loss})

    grid = tune.run(
        trainable,
        config={"base": tune.grid_search([1.0, 2.0, 10.0, 12.0])},
        metric="loss",
        mode="min",
        scheduler=tune.ASHAScheduler(metric="loss", mode="min", grace_period=1, max_t=8, reduction_factor=2),
        storage_path=storage,
        name="asha",
    )
    iters = {r.metrics["trial_id"]: r.metrics["training_iteration"] for r in grid}
    assert len(grid) == 4
    # the bad trials must not run all 8 iterations
    stopped_early = [v for v in iters.values() if v < 8]
    assert stopped_early, iters


def test_pbt_exploits_checkpoint(ray_start_regular, storage):
    def trainable(config):
        import tempfile

        ckpt = tune.get_checkpoint()
        level = 0.0
        if ckpt is not None:
            with ckpt.as_directory() as d:
                with open(os.path.join(d, "lvl")) as f:
                    level = float(f.read())
        for i in range(6):
            level += config["rate"]
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "lvl"), "w") as f:
                f.write(str(level))
            tune.report({"reward": level}, checkpoint=Checkpoint.from_directory(d))

    pbt = tune.PopulationBasedTraining(
        metric="reward",
        mode="max",
        perturbation_interval=2,
        hyperparam_mutations={"rate": tune.uniform(0.1, 2.0)},
        seed=0,
    )
    grid = tune.run(
        trainable,
        config={"rate": tune.grid_search([0.1, 2.0])},
        metric="reward",
        mode="max",
        scheduler=pbt,
        storage_path=storage,
        name="pbt",
    )
    best = grid.get_best_result()
    assert best.metrics["reward"] > 2.0  # high-rate path dominates


def test_synch_pbt_waits_for_the_slow_trial(ray_start_regular, storage):
    """The low-rate trial is fast and checkpoints only at even steps: at its
    step 2 the slow high-rate trial has no checkpoint yet, so asynchronous
    PBT could not exploit there. Synchronous PBT holds it until the slow
    trial reports step 2, then clones that trial's level at step 2."""
    def trainable(config):
        import tempfile
        import time

        ckpt = tune.get_checkpoint()
        level, step, restored = 0.0, 0, None
        if ckpt is not None:
            with ckpt.as_directory() as d:
                with open(os.path.join(d, "lvl")) as f:
                    level, step = (float(x) for x in f.read().split())
            step, restored = int(step), level
        while step < 4:
            if config["rate"] > 1.0:
                time.sleep(0.5)
            level += config["rate"]
            step += 1
            saved = None
            if step % 2 == 0:
                d = tempfile.mkdtemp()
                with open(os.path.join(d, "lvl"), "w") as f:
                    f.write(f"{level} {step}")
                saved = Checkpoint.from_directory(d)
            tune.report({"reward": level, "step": step, "restored": restored, "rate": config["rate"]},
                        checkpoint=saved)

    pbt = tune.PopulationBasedTraining(
        metric="reward", mode="max", perturbation_interval=2,
        hyperparam_mutations={"rate": tune.uniform(0.1, 4.0)}, resample_probability=0.0,
        seed=0, synch=True,
    )
    grid = tune.run(
        trainable, config={"rate": tune.grid_search([0.1, 2.0])}, metric="reward", mode="max",
        scheduler=pbt, storage_path=storage, name="pbt_synch",
    )
    slow_fast = sorted((r.metrics_history for r in grid), key=lambda h: h[0]["rate"], reverse=True)
    slow, fast = slow_fast
    assert [m["step"] for m in slow] == [1, 2, 3, 4] and slow[1]["restored"] is None
    assert [m["step"] for m in fast][:2] == [1, 2]
    after = fast[2]  # the fast trial's first report after its exploit at step 2
    assert after["step"] == 3 and after["restored"] == pytest.approx(4.0)
    assert after["rate"] in (pytest.approx(1.6), pytest.approx(2.4))
    assert after["reward"] == pytest.approx(4.0 + after["rate"])


def test_trial_failure_retry(ray_start_regular, storage, tmp_path):
    marker = str(tmp_path / "crashed_once")

    def trainable(config):
        if not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write("1")
            os._exit(1)
        tune.report({"ok": 1})

    grid = tune.Tuner(
        trainable,
        param_space={},
        tune_config=tune.TuneConfig(metric="ok", mode="max"),
        run_config=RunConfig(
            name="retry", storage_path=storage, failure_config=FailureConfig(max_failures=1)
        ),
    ).fit()
    assert grid[0].error is None
    assert grid[0].metrics["ok"] == 1


def test_experiment_state_written(ray_start_regular, storage):
    def trainable(config):
        tune.report({"m": config["x"]})

    tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2])},
        run_config=RunConfig(name="state", storage_path=storage),
    ).fit()
    state_file = os.path.join(storage, "state", "experiment_state.json")
    assert os.path.exists(state_file)
    import json

    state = json.load(open(state_file))
    assert len(state["trials"]) == 2
    assert all(t["state"] == "TERMINATED" for t in state["trials"])


def test_trainer_in_tuner(ray_start_regular, storage):
    """Reference: BaseTrainer.fit runs as a 1-trial Tune experiment; ours
    composes the other way — a Trainer is tunable via as_trainable()."""
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    def loop(config):
        from ray_tpu_torch import train

        train.report({"val": config["v"] * 2})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="inner", storage_path=storage),
    )
    grid = tune.Tuner(
        trainer,
        param_space={"v": tune.grid_search([1, 5])},
        tune_config=tune.TuneConfig(metric="val", mode="max"),
        run_config=RunConfig(name="outer", storage_path=storage),
    ).fit()
    assert grid.get_best_result().metrics["val"] == 10


# what the port adds


def test_fractional_gpu_trials_share_the_card(ray_start_regular, storage):
    """Two trials of half a GPU each run at once on the node's one card:
    each is bound to it before its trainable runs, and both are in flight
    together (each waits, bounded, until it sees the other's file)."""
    meet = os.path.join(storage, "meet")
    os.makedirs(meet)

    def trainable(config):
        import os
        import time

        open(os.path.join(meet, str(config["i"])), "w").close()
        deadline = time.monotonic() + 30
        while len(os.listdir(meet)) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        tune.report({"cards": os.environ["CUDA_VISIBLE_DEVICES"],
                     "together": len(os.listdir(meet)) == 2})

    grid = tune.Tuner(
        tune.with_resources(trainable, {"CPU": 1, "GPU": 0.5}),
        param_space={"i": tune.grid_search([0, 1])},
        tune_config=tune.TuneConfig(max_concurrent_trials=2),
        run_config=RunConfig(name="gpu_share", storage_path=storage),
    ).fit()
    assert grid.errors == []
    assert [(r.metrics["cards"], r.metrics["together"]) for r in grid] == [("3", True)] * 2
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "3"  # this process's own list is untouched


def test_gpu_trainer_in_tuner_leaves_the_card_to_its_worker(ray_start_regular, storage):
    """A trainer whose one worker holds the node's only GPU runs as a trial:
    the trial itself takes no GPU (else the worker could never be placed),
    and the worker is bound to the card."""
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    def loop(config):
        import os

        from ray_tpu_torch import train

        train.report({"lr": config["lr"], "cards": os.environ["CUDA_VISIBLE_DEVICES"]})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="inner_gpu", storage_path=storage),
    )
    grid = tune.Tuner(
        trainer,
        param_space={"lr": tune.grid_search([0.1, 0.2])},
        tune_config=tune.TuneConfig(metric="lr", mode="max", max_concurrent_trials=1),
        run_config=RunConfig(name="outer_gpu", storage_path=storage),
    ).fit()
    assert grid.errors == []
    assert grid.get_best_result().metrics == {
        "lr": 0.2, "cards": "3", "training_iteration": 1,
        "trial_id": grid.get_best_result().metrics["trial_id"],
    }


def test_registry_resolves_names_and_refuses_rl_algorithms():
    def trainable(config):
        tune.report({"x": 1})

    tune.register_trainable("mine", trainable)
    assert tune.resolve_trainable("mine") is trainable
    assert tune.resolve_trainable(trainable) is trainable
    # the port's rl registers every RL algorithm (an as_trainable function)
    assert tune.resolve_trainable("PPO").__name__ == "PPO"
    assert tune.resolve_trainable("DQN").__name__ == "DQN"
    assert tune.Tuner("DQN") is not None
    with pytest.raises(KeyError, match="Unknown trainable 'nope'"):
        tune.resolve_trainable("nope")


def test_result_grid_without_pandas_raises_at_use(monkeypatch):
    import sys

    from ray_tpu_torch.train import Result

    grid = tune.ResultGrid([Result(metrics={"m": 1}, checkpoint=None, path="p")], metric="m")
    assert grid.get_best_result().metrics == {"m": 1}
    monkeypatch.setitem(sys.modules, "pandas", None)  # an import of it now fails
    with pytest.raises(ImportError):
        grid.get_dataframe()
