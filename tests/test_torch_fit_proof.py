"""ray_tpu_torch.parallel.fit_proof on the CPU — a mirror of
``tests/test_fit_proof.py``: rank 0 of an fsdp-8 step built on the meta
device under a fake process group (nothing allocated). Its
``argument_bytes`` must equal the count from the local shards the rule
table gives (parameters and Adam's two moments), and the reference's own
report for the same config must have compiled. ``per_chip_bytes`` is
measured only on the card (``chip_smoke.py`` phase 34). GPT-J-6B's report
runs on the meta device here too."""

import math

import pytest
import torch.distributed as dist

from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.parallel.fit_proof import fit_report as ref_fit_report
from ray_tpu_torch.models.gpt import GPT, GPTConfig
from ray_tpu_torch.parallel.fit_proof import fit_report, gptj_6b_fit_report
from ray_tpu_torch.parallel.sharding import spec_for_path

FIELDS = dict(vocab_size=2048, seq_len=128, d_model=128, n_layers=2, n_heads=4)


def _expected_argument_bytes(model, n_devices: int) -> int:
    """Parameters and two Adam moments per parameter: a dim the rule table
    shards over fsdp holds 1/n of its rows on rank 0."""
    total = 0
    for name, p in model.named_parameters():
        shards = n_devices if any(e == "fsdp" or (isinstance(e, tuple) and "fsdp" in e)
                                  for e in spec_for_path(name)) else 1
        total += math.prod(p.shape) // shards * p.element_size() * 3
    return total


def test_fit_report_tiny_config_compiles_with_memory_analysis():
    cfg = GPTConfig(**FIELDS)
    rep = fit_report(cfg, n_devices=8, batch=8, device="meta")
    assert not dist.is_initialized()  # the fake group is gone
    assert rep["compiles"] is True
    assert rep["n_devices"] == 8
    assert rep["model_params"] > 500_000
    assert rep["argument_bytes"] == _expected_argument_bytes(GPT(cfg, device="meta"), 8)
    # args dominated by fp32 params + adam moments, as the reference's test says
    assert rep["argument_bytes"] > rep["model_params"] * 12 / 8 * 0.5
    assert "per_chip_bytes" not in rep  # measured only on the card
    ref = ref_fit_report(RefGPTConfig(**FIELDS), n_devices=8, batch=8)
    assert ref["compiles"] is True and ref["model_params"] == rep["model_params"]


def test_gptj_6b_fit_report_on_the_meta_device():
    from ray_tpu_torch.models.gptj import GPTJ, GPTJConfig

    rep = gptj_6b_fit_report(device="meta")
    assert not dist.is_initialized()
    assert rep["architecture"] == "gptj" and rep["compiles"] is True
    assert 5.9e9 < rep["model_params"] < 6.2e9
    cfg = GPTJConfig(vocab_size=50_432, seq_len=2048, remat_policy="full")
    assert rep["argument_bytes"] == _expected_argument_bytes(GPTJ(cfg, device="meta"), 8)


def test_fit_report_refuses_an_existing_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="destroy"):
            fit_report(GPTConfig(**FIELDS), device="meta")
    finally:
        dist.destroy_process_group()
