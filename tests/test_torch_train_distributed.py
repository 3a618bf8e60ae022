"""``TorchConfig(init_distributed=True)``: two CPU train workers join one
``torch.distributed`` gloo group through ``TorchBackend`` — the train
context's ranks agree with the group's and with ``RANK``/``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT`` name rank 0, and an ``all_reduce`` sums
across the workers; the group is torn down with the worker group."""

import pytest

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchConfig, TorchTrainer


@pytest.fixture(scope="module")
def _shared_cluster():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def test_two_workers_join_one_gloo_group(_shared_cluster, tmp_path):
    # nested, so the loop travels to the workers by value
    def _loop(config):
        import os

        import torch
        import torch.distributed as dist

        ctx = train.get_context()
        t = torch.tensor([float(ctx.get_world_rank() + 1), 10.0 ** ctx.get_world_rank()])
        dist.all_reduce(t)
        train.report({
            "initialized": dist.is_initialized(),
            "backend": dist.get_backend(),
            "ranks": [ctx.get_world_rank(), dist.get_rank(), int(os.environ["RANK"])],
            "worlds": [ctx.get_world_size(), dist.get_world_size(), int(os.environ["WORLD_SIZE"])],
            "local_rank": int(os.environ["LOCAL_RANK"]),
            "master": (os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"])),
            "sum": t.tolist(),
        })

    result = TorchTrainer(
        _loop,
        scaling_config=ScalingConfig(num_workers=2),
        backend_config=TorchConfig(init_distributed=True, timeout_s=60),
        run_config=RunConfig(name="dist", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None
    m = result.metrics
    assert m["initialized"] and m["backend"] == "gloo"
    assert m["ranks"] == [0, 0, 0] and m["worlds"] == [2, 2, 2]
    assert m["local_rank"] == 0 and m["master"][1] > 0
    assert m["sum"] == [3.0, 11.0]


def test_backend_choice():
    assert TorchConfig().backend_name(use_gpu=False) == "gloo"
    assert TorchConfig().backend_name(use_gpu=True) == "nccl"
    assert TorchConfig(backend="gloo").backend_name(use_gpu=True) == "gloo"


def test_one_worker_joins_no_group(_shared_cluster, tmp_path):
    """A single worker trains without a process group (as the reference
    skips ``jax.distributed.initialize`` for one host)."""

    def loop():
        import torch.distributed as dist

        train.report({"initialized": dist.is_available() and dist.is_initialized()})

    result = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1),
        backend_config=TorchConfig(init_distributed=True),
        run_config=RunConfig(name="one", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None and result.metrics["initialized"] is False
