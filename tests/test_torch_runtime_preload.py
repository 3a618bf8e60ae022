"""``preload_python_modules``: the forkserver template imports the listed
modules once before it forks any worker, so every forked worker starts
with them. The option is one cluster's: ``shutdown`` restores it, and a
name that no module has raises at ``init``. Without the option a worker
has none of them."""

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.config import GLOBAL_CONFIG

#: a standard-library module nothing in a worker imports by itself
PROBE = "colorsys"


@ray_tpu_torch.remote
def _loaded(name: str) -> bool:
    import sys

    return name in sys.modules


@pytest.mark.parametrize("preload", ["", f"{PROBE}, json"])
def test_template_preloads_modules(preload):
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, _system_config={"preload_python_modules": preload})
    try:
        assert ray_tpu_torch.get(_loaded.remote(PROBE), timeout=60) is bool(preload)
    finally:
        ray_tpu_torch.shutdown()
    assert GLOBAL_CONFIG.preload_python_modules == ""


@pytest.mark.parametrize("name", ["no_such_module_for_preload", "no_such_package_for_preload.sub"])
def test_a_missing_module_raises_at_init(name):
    with pytest.raises(ValueError, match=name):
        ray_tpu_torch.init(num_cpus=1, num_gpus=0, _system_config={"preload_python_modules": f"{PROBE},{name}"})
    assert not ray_tpu_torch.is_initialized()
    assert GLOBAL_CONFIG.preload_python_modules == ""
