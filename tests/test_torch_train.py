"""The port's Train against the reference's tests: a mirror of
``tests/test_train.py`` run on ``ray_tpu_torch.train`` with ``TorchTrainer``
(session plumbing, configs, checkpointing, failure recovery, and the
minimum end-to-end slice: a torch MLP trained in a train worker, its state
checkpointed and restored). The runtime is shared by the module."""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.train import (
    Checkpoint,
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
)


@pytest.fixture(scope="module")
def _shared_cluster():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_regular(_shared_cluster):
    yield


@pytest.fixture
def storage(tmp_path):
    return str(tmp_path / "results")


def test_report_metrics(ray_start_regular, storage):
    def loop(config):
        for i in range(3):
            train.report({"step": i, "loss": 10.0 - i})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="t1", storage_path=storage),
    )
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    assert len(result.metrics_history) == 3


def test_context_ranks(ray_start_regular, storage):
    def loop():
        ctx = train.get_context()
        train.report({"rank": ctx.get_world_rank(), "world": ctx.get_world_size(),
                      "env": (os.environ["RANK"], os.environ["WORLD_SIZE"])})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="t2", storage_path=storage),
    )
    result = trainer.fit()
    assert result.metrics["world"] == 2
    # rank 0's report wins, and the backend's torch.distributed variables agree
    assert result.metrics["rank"] == 0 and tuple(result.metrics["env"]) == ("0", "2")


def test_train_loop_config_passed(ray_start_regular, storage):
    def loop(config):
        train.report({"doubled": config["x"] * 2})

    result = TorchTrainer(
        loop,
        train_loop_config={"x": 21},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="t3", storage_path=storage),
    ).fit()
    assert result.metrics["doubled"] == 42


def test_checkpointing_and_keep_n(ray_start_regular, storage, tmp_path):
    def loop(config):
        import tempfile

        for i in range(4):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "state.txt"), "w") as f:
                f.write(str(i))
            train.report({"i": i, "score": float(i)}, checkpoint=Checkpoint.from_directory(d))

    result = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="t4",
            storage_path=storage,
            checkpoint_config=CheckpointConfig(
                num_to_keep=2, checkpoint_score_attribute="score"
            ),
        ),
    ).fit()
    assert result.checkpoint is not None
    with result.checkpoint.as_directory() as d:
        with open(os.path.join(d, "state.txt")) as f:
            assert f.read() == "3"
    trial_dir = result.path
    kept = [d for d in os.listdir(trial_dir) if d.startswith("checkpoint_")]
    assert len(kept) == 2


def test_worker_failure_restarts_from_checkpoint(ray_start_regular, storage):
    def loop(config):
        import tempfile

        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            with ckpt.as_directory() as d:
                with open(os.path.join(d, "step")) as f:
                    start = int(f.read()) + 1
        for i in range(start, 3):
            if i == 1 and start == 0:
                os._exit(1)  # hard crash before step 1 on the first attempt
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "step"), "w") as f:
                f.write(str(i))
            train.report({"step": i, "resumed_at": start}, checkpoint=Checkpoint.from_directory(d))

    result = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="t5",
            storage_path=storage,
            failure_config=FailureConfig(max_failures=1),
        ),
    ).fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    assert result.metrics["resumed_at"] == 1  # resumed from the step-0 checkpoint


def test_failure_budget_exhausted(ray_start_regular, storage):
    def loop(config):
        os._exit(1)

    result = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="t6", storage_path=storage),
    ).fit()
    assert result.error is not None


def test_e2e_torch_mlp(ray_start_regular, storage):
    """Minimum end-to-end slice, the counterpart of the reference's
    ``test_e2e_pjit_mlp_dp``: a torch MLP trained by ``build_train_step``
    inside a train worker on the CPU, its train state checkpointed with
    ``save_state`` and the loss falling; the checkpoint restores the
    trained weights into a fresh state."""

    def loop(config):
        import tempfile

        import torch

        from ray_tpu_torch.parallel import build_train_step

        torch.set_num_threads(1)  # the worker shares the suite's cores
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(16, 64), torch.nn.Tanh(), torch.nn.Linear(64, 1))

        def loss_fn(p, batch):
            x, y = batch
            return ((p(x) - y) ** 2).mean()

        init_fn, step_fn = build_train_step(loss_fn, lambda ps: torch.optim.Adam(ps, lr=1e-2))
        state = init_fn(model, "cpu")
        rng = np.random.RandomState(0)
        xs = torch.from_numpy(rng.randn(256, 16).astype(np.float32))
        ys = xs.sum(dim=1, keepdim=True) * 0.5
        first = last = None
        for _ in range(30):
            state, loss = step_fn(state, (xs, ys))
            first = loss.item() if first is None else first
            last = loss.item()
        d = tempfile.mkdtemp()
        train.save_state(state, d)
        train.report({"first_loss": first, "loss": last}, checkpoint=Checkpoint.from_directory(d))

    result = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="e2e", storage_path=storage),
    ).fit()
    assert result.error is None
    assert result.metrics["loss"] < result.metrics["first_loss"] * 0.5
    tree = train.load_pytree(result.checkpoint)
    assert tree["params"]["0.weight"].shape == (64, 16) and tree["step"] == 30
    assert result.checkpoint.get_metadata()["step"] == 30

    import torch

    from ray_tpu_torch.parallel import build_train_step

    model = torch.nn.Sequential(torch.nn.Linear(16, 64), torch.nn.Tanh(), torch.nn.Linear(64, 1))
    init_fn, _ = build_train_step(lambda p, b: p(b).sum(), lambda ps: torch.optim.Adam(ps, lr=1e-2))
    state = train.load_state(result.checkpoint, init_fn(model, "cpu"))
    assert state.step == 30
    np.testing.assert_array_equal(state.params[0].weight.detach().numpy(), tree["params"]["0.weight"])
    x = torch.ones(1, 16)
    assert torch.isfinite(state.params(x)).all()


def test_dataset_shard_plain_iterable(ray_start_regular, storage):
    def loop(config):
        shard = train.get_dataset_shard("train")
        total = sum(shard)
        train.report({"total": total})

    result = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="t7", storage_path=storage),
        datasets={"train": list(range(10))},
    ).fit()
    # each worker sums its round-robin half; rank-0's metrics reported
    assert result.metrics["total"] in (20, 25)


def test_gpu_workers_on_a_cluster_without_a_gpu_fail_at_once(ray_start_regular, storage):
    """``use_gpu`` asks each worker for one ``GPU``; on a cluster without a
    card the request fails at once instead of training on the CPU."""
    assert ScalingConfig(num_workers=2, use_gpu=True).worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    with pytest.raises(TypeError):
        ScalingConfig(use_tpu=True)

    def loop(config):
        train.report({"ran": True})

    with pytest.raises(Exception, match="GPU"):
        TorchTrainer(
            loop,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="t8", storage_path=storage),
        ).fit()


def test_as_trainable_waits_for_tune(ray_start_regular, storage):
    """``as_trainable`` is what Tune runs as a trial: the trial's config
    merged over ``train_loop_config``, the trainer's final metrics its one
    report (it raised before ``tune`` was ported)."""
    from ray_tpu_torch import tune

    def loop(config):
        train.report({"a": config["a"], "b": config["b"]})

    trainable = TorchTrainer(
        loop,
        train_loop_config={"a": 1, "b": 2},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="inner", storage_path=storage),
    ).as_trainable()
    grid = tune.Tuner(trainable, param_space={"b": 5},
                      run_config=RunConfig(name="outer", storage_path=storage)).fit()
    assert grid.errors == []
    assert (grid[0].metrics["a"], grid[0].metrics["b"]) == (1, 5)
