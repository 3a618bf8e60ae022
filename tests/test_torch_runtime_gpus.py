"""GPUs in the port's runtime, on the CPU (the card itself is faked).

The card is a ``GPU`` resource (``ray_tpu_torch/accelerators/gpu.py``, the
counterpart of ``ray_tpu/accelerators/tpu.py``): detection from
``CUDA_VISIBLE_DEVICES`` and ``nvidia-smi``, an accelerator-type resource
named after the card, ``num_gpus`` scheduling on logical GPUs, and a GPU
request on a cluster without one fails instead of running on the CPU or
waiting.
"""

import os
import stat
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import exceptions as rex
from ray_tpu_torch.accelerators import gpu


def _fake_smi(tmp_path, lines, rc=0):
    script = tmp_path / "nvidia-smi"
    script.write_text("#!/bin/sh\n" + "".join(f"echo '{line}'\n" for line in lines) + f"exit {rc}\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(tmp_path)


H100 = "GPU {}: NVIDIA H100 80GB HBM3 (UUID: GPU-{})"


@pytest.mark.parametrize(
    "visible,smi,want",
    [
        (None, None, 0),  # no tool, no env, torch has no card here
        (None, [H100.format(0, "a")], 1),
        (None, [H100.format(i, i) for i in range(4)], 4),
        ("0,1", [H100.format(i, i) for i in range(4)], 2),
        ("", [H100.format(0, "a")], 0),
        ("-1", [H100.format(0, "a")], 0),
        ("2,-1,3", [H100.format(i, i) for i in range(4)], 1),
        ("GPU-a,GPU-b", None, 2),
    ],
)
def test_gpu_detection(monkeypatch, tmp_path, visible, smi, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)  # the same on any host
    monkeypatch.setenv("PATH", _fake_smi(tmp_path, smi) if smi is not None else str(tmp_path))
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert gpu.detect_num_gpus() == want
    extra = gpu.extra_resources(want)
    if want and smi is not None:
        assert extra == {"GPU-NVIDIA-H100-80GB-HBM3": float(want)}
    else:
        assert extra == {}


def test_loaded_torch_is_the_last_source(monkeypatch, tmp_path):
    """With neither the variable nor the tool, a torch that is already
    loaded counts the cards; the accelerator type then needs CUDA to be up
    already (detection never initialises it)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert gpu.detect_num_gpus() == 2
    assert gpu.extra_resources(2) == {}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert gpu.extra_resources(2) == {"GPU-NVIDIA-H100-80GB-HBM3": 2.0}


def test_failing_nvidia_smi_counts_no_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setenv("PATH", _fake_smi(tmp_path, ["NVIDIA-SMI has failed"], rc=9))
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert gpu.nvidia_smi_cards() is None and gpu.detect_num_gpus() == 0


def test_init_without_arguments_offers_the_detected_card(monkeypatch, tmp_path):
    """``init()`` with no arguments on an H100 host gives ``GPU: 1`` and the
    accelerator-type resource named after the card."""
    monkeypatch.setenv("PATH", _fake_smi(tmp_path, [H100.format(0, "a")]) + os.pathsep + os.environ["PATH"])
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    ray_tpu_torch.init(num_cpus=1)
    try:
        res = ray_tpu_torch.cluster_resources()
        assert res["GPU"] == 1.0 and res["GPU-NVIDIA-H100-80GB-HBM3"] == 1.0
    finally:
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1, num_gpus=0)  # an explicit count wins
    try:
        assert ray_tpu_torch.cluster_resources().get("GPU") == 0.0
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture
def logical_gpus():
    ray_tpu_torch.init(num_cpus=4, num_gpus=2)
    yield
    ray_tpu_torch.shutdown()


def test_num_gpus_scheduling_on_logical_gpus(logical_gpus, tmp_path):
    """Two GPUs: two whole-GPU tasks run side by side and a third waits for
    one; four half-GPU tasks share; a whole-GPU actor holds its GPU for its
    life."""

    @ray_tpu_torch.remote(num_gpus=1)
    def hold(tag, gate):
        import os
        import time

        t0 = time.time()
        while not os.path.exists(gate):
            time.sleep(0.01)
        return tag, t0, time.time()

    gate = tmp_path / "gate"
    refs = [hold.remote(i, str(gate)) for i in range(3)]
    ready, pending = ray_tpu_torch.wait(refs, num_returns=1, timeout=1.0)
    assert ready == []
    assert ray_tpu_torch.available_resources().get("GPU", 0.0) == 0.0
    gate.touch()
    spans = sorted(ray_tpu_torch.get(refs, timeout=60), key=lambda r: r[1])
    # the third started only after one of the first two ended
    assert spans[2][1] >= min(spans[0][2], spans[1][2])

    @ray_tpu_torch.remote(num_gpus=0.5)
    def half():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    assert len(ray_tpu_torch.get([half.remote() for _ in range(4)], timeout=60)) == 4

    @ray_tpu_torch.remote(num_gpus=1)
    class OnCard:
        def ping(self):
            return "pong"

    a = OnCard.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "pong"
    assert ray_tpu_torch.available_resources().get("GPU", 0.0) == 1.0
    ray_tpu_torch.kill(a)
    deadline = time.monotonic() + 30
    while ray_tpu_torch.available_resources().get("GPU", 0.0) != 2.0:
        assert time.monotonic() < deadline, ray_tpu_torch.available_resources()
        time.sleep(0.05)


def test_two_whole_gpu_tasks_on_one_card_do_not_overlap():
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    try:
        @ray_tpu_torch.remote(num_gpus=1)
        def span():
            import time

            t0 = time.time()
            time.sleep(0.3)
            return t0, time.time()

        (a0, a1), (b0, b1) = sorted(ray_tpu_torch.get([span.remote(), span.remote()], timeout=60))
        assert b0 >= a1
    finally:
        ray_tpu_torch.shutdown()


def test_gpu_request_without_a_card_raises():
    """A cluster with no GPU: a GPU task fails at once, naming the missing
    resource, and a GPU actor's calls fail; neither runs on the CPU nor
    waits silently."""
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    try:
        _gpu_request_fails()
    finally:
        ray_tpu_torch.shutdown()


def _gpu_request_fails():

    @ray_tpu_torch.remote(num_gpus=1)
    def on_card():
        return "ran"

    with pytest.raises(rex.RayError, match="no node of this cluster has a GPU"):
        ray_tpu_torch.get(on_card.remote(), timeout=30)

    @ray_tpu_torch.remote(num_gpus=1)
    class OnCard:
        def ping(self):
            return "pong"

    a = OnCard.remote()
    with pytest.raises(rex.ActorDiedError, match="no node of this cluster has a GPU"):
        ray_tpu_torch.get(a.ping.remote(), timeout=30)
    # CPU work still runs
    assert ray_tpu_torch.get(ray_tpu_torch.remote(lambda: 1).remote(), timeout=30) == 1
