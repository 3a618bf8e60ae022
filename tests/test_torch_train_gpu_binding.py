"""GPU train workers get cards of their own: the worker group narrows each
worker's ``CUDA_VISIBLE_DEVICES`` to its share of the node's cards by local
rank, so two workers of one group never land on one card. Remote RL
learners are bound the same way by their index in their group, before
their ``__init__``. Runs on the CPU with a node that offers two ``GPU`` and
lists the cards ``3,5``; nothing here touches CUDA."""

import os

import pytest

import ray_tpu_torch
from ray_tpu_torch import train
from ray_tpu_torch.accelerators import gpu
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
from ray_tpu_torch.train._worker_group import WorkerGroup


@pytest.fixture(scope="module")
def _two_card_node():
    mp = pytest.MonkeyPatch()
    mp.setenv("CUDA_VISIBLE_DEVICES", "3,5")  # the node's cards; workers inherit the list
    ray_tpu_torch.init(num_cpus=4, num_gpus=2)
    yield
    ray_tpu_torch.shutdown()
    mp.undo()


@pytest.mark.parametrize(
    "num_workers, gpus, expected",
    [(2, 1.0, ["3", "5"]), (4, 0.5, ["3", "3", "5", "5"]), (1, 2.0, ["3,5"])],
    ids=["one_card_each", "half_card_each", "two_cards"],
)
def test_gpu_workers_bind_their_own_cards(_two_card_node, num_workers, gpus, expected):
    def visible_devices():  # nested, so it travels to the workers by value
        import os

        return os.environ.get("CUDA_VISIBLE_DEVICES")

    wg = WorkerGroup(num_workers, {"CPU": 1.0, "GPU": gpus})
    try:
        seen = wg.execute(visible_devices)
        by_local_rank = [seen[wg.local_ranks.index(r)] for r in range(num_workers)]
        assert by_local_rank == expected
    finally:
        wg.shutdown()
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "3,5"  # the driver's own list is untouched


def test_trainer_loop_sees_its_card(_two_card_node, tmp_path):
    def loop():
        import os

        ctx = train.get_context()
        train.report({"rank": ctx.get_world_rank(), "cards": os.environ["CUDA_VISIBLE_DEVICES"]})

    result = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=True),
        run_config=RunConfig(name="cards", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None
    # rank 0's report: local rank 0 on the one node holds the first card
    assert result.metrics == {"rank": 0, "cards": "3"}


@pytest.mark.parametrize(
    "index, gpus, expected",
    [(0, 0.25, "3"), (3, 0.25, "3"), (4, 0.25, "5"), (1, 1.0, "5"), (0, 2.0, "3,5")],
)
def test_bind_cards_packs_a_share_by_index(monkeypatch, index, gpus, expected):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    assert gpu.bind_cards(index, gpus) == expected
    assert os.environ["CUDA_VISIBLE_DEVICES"] == expected


def test_bind_cards_refuses_a_share_past_the_cards(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    with pytest.raises(RuntimeError, match="from card index 2"):
        gpu.bind_cards(2, 1.0)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "3,5"


@pytest.mark.parametrize("gpus, expected", [(1.0, ["3", "5"]), (0.5, ["3", "3"])],
                         ids=["one_card_each", "half_card_each"])
def test_remote_learners_bind_their_share(_two_card_node, monkeypatch, gpus, expected):
    """Each remote learner holds its GPU share and sees only its card from
    ``__init__`` on (the learners run on the CPU here, holding a share)."""
    from ray_tpu_torch.rl import learner as rl_learner
    from ray_tpu_torch.rl.rl_module import ActorCriticModule, RLModuleSpec
    from ray_tpu_torch.rl.spaces import Box, Discrete

    monkeypatch.setattr(rl_learner, "gpu_share", lambda device, share: share)
    spec = RLModuleSpec(Box(-1, 1, shape=(4,)), Discrete(2))

    def loss_fn(module, params, batch):
        raise AssertionError("no update here")

    def visible_devices(learner):  # nested, so it travels to the actors by value
        import os

        return os.environ.get("CUDA_VISIBLE_DEVICES")

    group = rl_learner.LearnerGroup(
        dict(module_factory=lambda: ActorCriticModule(spec), loss_fn=loss_fn, device="cpu"),
        num_learners=2, num_gpus=gpus,
    )
    try:
        assert ray_tpu_torch.get([a.apply.remote(visible_devices) for a in group._actors]) == expected
    finally:
        group.shutdown()
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "3,5"
