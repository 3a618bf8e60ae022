"""Tensors in the port's runtime, on the CPU.

``torch.Tensor`` values travel out-of-band through the object plane
(``ray_tpu_torch/_private/serialization.py``): every dtype and layout
round-trips exactly through ``serialize``, a driver ``put``/``get`` and a
task, and a large tensor read on the same node is a zero-copy view of the
shared-memory store. A CUDA tensor arriving where there is no card raises.
The forkserver template imports no torch, so a forked worker can still
open the card.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.shm_store import shm_mapping_of


def _cases():
    g = torch.Generator().manual_seed(0)
    base = torch.randn(64, 96, generator=g)
    return {
        "fp32": torch.randn(3000, generator=g),
        "bf16": torch.randn(40, 300, generator=g).to(torch.bfloat16),
        "fp16": torch.randn(5000, generator=g).half(),
        "int64": torch.randint(-(2**40), 2**40, (700,), generator=g),
        "bool": torch.rand(9000, generator=g) > 0.5,
        "complex64": torch.randn(600, dtype=torch.complex64, generator=g),
        "fp8": torch.randn(8192, generator=g).to(torch.float8_e4m3fn),
        "transposed": base.t(),
        "strided": base[::3, 5:80:2],
        "offset_view": base.view(-1)[1001:5001],
        "expanded": torch.arange(7.0)[:, None].expand(7, 1000),
        "zero_dim": torch.tensor(2.5),
        "empty": torch.empty(0, 17),
        "requires_grad": torch.randn(2000, generator=g, requires_grad=True),
    }


CASES = _cases()


def _same(got, want):
    assert type(got) is torch.Tensor
    assert got.dtype == want.dtype and got.shape == want.shape and got.device.type == "cpu"
    assert got.requires_grad == want.requires_grad
    if want.dtype.is_floating_point and want.element_size() == 1:
        got, want = got.view(torch.uint8), want.view(torch.uint8)  # fp8: compare the bits
    assert torch.equal(got.detach(), want.detach())


@pytest.mark.parametrize("name", list(CASES))
def test_serialize_round_trip(name):
    want = CASES[name]
    sv = ser.serialize(want)
    got = ser.deserialize_value(ser.SerializedValue.from_bytes(sv.to_bytes()))
    _same(got, want)
    if want.is_contiguous() or name == "transposed":
        assert got.stride() == want.stride()  # dense layouts keep their strides
    if want.numel() * want.element_size() >= 8192:
        # the bytes travel out-of-band, not through the pickle stream
        assert len(sv.buffers) == 1 and len(sv.header) < 1024


def test_serialization_imports_no_torch():
    """The reducer looks at torch only when it is already loaded (the
    forkserver template imports this module)."""
    code = ("import sys; import ray_tpu_torch._private.serialization as s; "
            "s.serialize({'a': [1, 2.0, 'x']}); sys.exit('torch' in sys.modules)")
    import subprocess

    proc = subprocess.run([sys.executable, "-c", code], env={**os.environ, "PYTHONPATH": os.getcwd()},
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def test_non_leaf_tensor_arrives_as_a_leaf():
    """As torch's own pickling: a tensor in a graph arrives detached, a leaf
    that requires grad."""
    x = torch.randn(5000, requires_grad=True)
    y = x * 2
    got = ser.deserialize_value(ser.serialize(y))
    assert got.is_leaf and got.requires_grad and torch.equal(got, y.detach())


def test_module_and_parameters_round_trip():
    """A module's parameters keep their class and travel out-of-band."""
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(64, 128), torch.nn.LayerNorm(128))
    sv = ser.serialize(m)
    got = ser.deserialize_value(sv)
    assert len(sv.buffers) == 1  # the 32 KB weight; the small vectors ride in-band
    for (name, a), b in zip(m.named_parameters(), got.parameters()):
        assert type(b) is torch.nn.Parameter and b.requires_grad and torch.equal(a, b), name


def test_cuda_tensor_on_a_receiver_without_a_card_raises(monkeypatch):
    """A CUDA tensor's reduction names its device; rebuilt where there is no
    card, it raises rather than coming back on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = pickle.PickleBuffer(np.arange(16, dtype=np.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ser._rebuild_tensor(buf, "float32", (16,), (1,), False, "cuda")


class _CudaTensorStandIn:
    """What a CUDA tensor pickles to, made on the CPU (no card here)."""

    def __reduce__(self):
        return ser._rebuild_tensor, (
            pickle.PickleBuffer(np.arange(4096, dtype=np.int32)), "float32", (4096,), (1,), False, "cuda",
        )


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


@pytest.mark.parametrize("name", list(CASES))
def test_tensor_through_put_get_and_a_task(cluster, name):
    want = CASES[name]
    _same(ray_tpu_torch.get(ray_tpu_torch.put(want), timeout=60), want)

    @ray_tpu_torch.remote
    def echo(t):
        return t

    _same(ray_tpu_torch.get(echo.remote(want), timeout=60), want)


def test_large_tensor_get_is_zero_copy(cluster):
    """A large CPU tensor read on the same node is a view of the store's
    shared memory, in the driver and in a worker."""
    want = torch.randn(1 << 22)  # 16 MB
    bf = torch.randn(1 << 21).to(torch.bfloat16)
    for x in (want, bf):
        got = ray_tpu_torch.get(ray_tpu_torch.put(x), timeout=60)
        assert torch.equal(got, x) and got.dtype == x.dtype
        assert (shm_mapping_of(got.data_ptr()) or "").startswith("/dev/shm/")
    assert shm_mapping_of(want.data_ptr()) is None  # a private tensor is not

    @ray_tpu_torch.remote
    def where(t):
        from ray_tpu_torch._private.shm_store import shm_mapping_of as mapped

        return mapped(t.data_ptr()), float(t[:100].sum())

    seg, head = ray_tpu_torch.get(where.remote(want), timeout=60)
    assert seg.startswith("/dev/shm/") and head == float(want[:100].sum())


def test_cuda_tensor_get_without_a_card_raises(cluster):
    ref = ray_tpu_torch.put(_CudaTensorStandIn())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ray_tpu_torch.get(ref, timeout=60)

    @ray_tpu_torch.remote
    def receive(x):
        return x

    with pytest.raises(rex.RayTaskError, match="no CUDA device"):
        ray_tpu_torch.get(receive.remote(_CudaTensorStandIn()), timeout=60)


def test_template_holds_no_torch(cluster):
    """The forkserver template every worker is forked from never imports
    torch nor initialises CUDA: its mappings hold no torch or CUDA library,
    even after its workers ran torch (a fresh worker's modules are checked
    in tests/test_torch_isolation.py)."""

    @ray_tpu_torch.remote
    def parent():
        import os

        import torch

        torch.ones(3).sum()
        return os.getppid()

    template_pid = ray_tpu_torch.get(parent.remote(), timeout=60)
    with open(f"/proc/{template_pid}/cmdline", "rb") as f:
        assert b"ray_tpu_torch._private.worker_template" in f.read()
    with open(f"/proc/{template_pid}/maps") as f:
        maps = f.read()
    assert "libtorch" not in maps and "libcuda" not in maps and "libc10" not in maps
