"""ray_tpu_torch.train's checkpoints and storage, on the CPU.

``save_pytree``/``load_pytree`` round-trip trees of tensors and arrays (an
optimizer's ``state_dict`` with its int keys included) through the
reference's file names, with the leaves numbered as the reference's
``save_pytree`` numbers them; ``save_state``/``load_state`` continue AdamW
training bit for bit against an unbroken run; and local storage works with
pyarrow unimportable, while a URI then raises ``ImportError``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt
from ray_tpu_torch.parallel import adamw, build_train_step
from ray_tpu_torch.train import (
    Checkpoint,
    CheckpointConfig,
    load_pytree,
    load_state,
    save_pytree,
    save_state,
)
from ray_tpu_torch.train import _storage
from ray_tpu_torch.train._checkpoint_manager import CheckpointManager

CFG = gpt.GPTConfig(vocab_size=128, seq_len=16, d_model=32, n_layers=2, n_heads=2, dtype="float32")


def _batches(n):
    rng = np.random.RandomState(5)
    return [torch.from_numpy(rng.randint(0, CFG.vocab_size, (2, CFG.seq_len + 1))) for _ in range(n)]


def _fresh_state():
    init_fn, step_fn = build_train_step(lambda p, t: gpt.gpt_loss(CFG, p, t), adamw(1e-2))
    params = gpt.gpt_init(CFG, torch.Generator().manual_seed(0), "cpu")
    return init_fn(params, "cpu"), step_fn


def test_pytree_round_trip_keeps_structure_and_values(tmp_path):
    tree = {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "half": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
        "nested": {"a": [np.arange(3), (np.float32(2.5), 7)], "none": None, "name": "x"},
        3: {"ints": np.array([1, 2], dtype=np.int64)},
    }
    ckpt = save_pytree(tree, str(tmp_path / "ck"), step=4)
    assert ckpt.get_metadata() == {"step": 4}
    back = load_pytree(ckpt)
    np.testing.assert_array_equal(back["w"], tree["w"].numpy())
    assert back["w"].dtype == np.float32
    # bf16 comes back widened to fp32, exactly
    np.testing.assert_array_equal(back["half"], np.array([1.5, -2.25], np.float32))
    assert isinstance(back["nested"]["a"], list) and isinstance(back["nested"]["a"][1], tuple)
    np.testing.assert_array_equal(back["nested"]["a"][0], np.arange(3))
    assert back["nested"]["a"][1] == (2.5, 7) and back["nested"]["none"] is None
    assert back["nested"]["name"] == "x"
    assert 3 in back and "3" not in back
    np.testing.assert_array_equal(back[3]["ints"], [1, 2])


def test_optimizer_state_dict_round_trips(tmp_path):
    state, step_fn = _fresh_state()
    for b in _batches(2):
        state, _ = step_fn(state, b)
    sd = state.opt_state.state_dict()
    assert all(isinstance(k, int) for k in sd["state"])
    save_pytree(sd, str(tmp_path / "opt"))
    back = load_pytree(str(tmp_path / "opt"))
    assert sorted(back["state"]) == sorted(sd["state"])
    assert back["param_groups"][0]["betas"] == sd["param_groups"][0]["betas"]
    assert back["param_groups"][0]["params"] == sd["param_groups"][0]["params"]
    for k, per in sd["state"].items():
        for name, t in per.items():
            np.testing.assert_array_equal(back["state"][k][name], t.numpy())
    # the optimizer takes it back
    fresh, _ = _fresh_state()
    from ray_tpu_torch.train._checkpoint import _tensors

    fresh.opt_state.load_state_dict(_tensors(back))


def test_save_and_load_state_continue_bit_for_bit(tmp_path):
    """4 AdamW steps unbroken against 2 steps, ``save_state``, a fresh
    model and optimizer, ``load_state`` and 2 more steps: the same losses
    and parameters, bit for bit."""
    batches = _batches(4)
    state, step_fn = _fresh_state()
    unbroken = []
    for b in batches:
        state, loss = step_fn(state, b)
        unbroken.append(loss.item())

    first, step_fn = _fresh_state()
    cut = []
    for b in batches[:2]:
        first, loss = step_fn(first, b)
        cut.append(loss.item())
    ckpt = save_state(first, str(tmp_path / "state"))
    assert ckpt.get_metadata()["step"] == 2
    resumed, step_fn = _fresh_state()
    resumed = load_state(ckpt, resumed)
    assert resumed.step == 2
    for b in batches[2:]:
        resumed, loss = step_fn(resumed, b)
        cut.append(loss.item())
    assert cut == unbroken
    assert resumed.step == state.step == 4
    for (name, a), (_, b) in zip(resumed.params.named_parameters(), state.params.named_parameters()):
        assert torch.equal(a, b), name


def test_checkpoint_files_have_the_reference_names(tmp_path):
    """The same tree through the reference's ``save_pytree`` and the
    port's: the port writes the reference's files (less its pickled JAX
    treedef), the same ``leaf_<i>`` members with the same arrays, and
    ``treedef.json`` with its keys."""
    from ray_tpu.train import save_pytree as ref_save_pytree

    rng = np.random.RandomState(0)
    tree = {"b": {"y": rng.randn(3).astype(np.float32), "x": rng.randn(2, 2).astype(np.float32)},
            "a": [np.arange(4), rng.randn(5).astype(np.float32)]}
    ref_save_pytree(tree, str(tmp_path / "ref"), step=9)
    save_pytree(tree, str(tmp_path / "port"), step=9)
    ref_files = set(os.listdir(tmp_path / "ref"))
    port_files = set(os.listdir(tmp_path / "port"))
    assert port_files == {"pytree.npz", "treedef.json", ".ray_tpu_checkpoint.json"}
    assert port_files <= ref_files and ref_files - port_files == {"treedef.pkl"}
    with np.load(tmp_path / "ref" / "pytree.npz") as r, np.load(tmp_path / "port" / "pytree.npz") as p:
        assert sorted(r.files) == sorted(p.files)
        for name in r.files:
            np.testing.assert_array_equal(p[name], r[name])
    import json

    ref_meta = json.loads((tmp_path / "ref" / "treedef.json").read_text())
    port_meta = json.loads((tmp_path / "port" / "treedef.json").read_text())
    assert {k: port_meta[k] for k in ref_meta} == ref_meta == {"n_leaves": 4, "step": 9}
    assert Checkpoint(str(tmp_path / "port")).get_metadata() == Checkpoint(
        str(tmp_path / "ref")).get_metadata()


@pytest.fixture
def no_pyarrow(monkeypatch):
    """pyarrow unimportable, as on a machine without it."""
    for name in list(sys.modules):
        if name == "pyarrow" or name.startswith("pyarrow."):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.fs", None)


def test_local_storage_needs_no_pyarrow(no_pyarrow, tmp_path):
    with pytest.raises(ImportError):
        import pyarrow  # noqa: F401
    ckpt = save_pytree({"w": np.ones(3)}, str(tmp_path / "ck"), step=1)
    np.testing.assert_array_equal(load_pytree(ckpt)["w"], np.ones(3))
    copy = ckpt.to_directory(str(tmp_path / "copy"))
    assert sorted(os.listdir(copy)) == [".ray_tpu_checkpoint.json", "pytree.npz", "treedef.json"]
    # the keep-N manager over plain directories
    manager = CheckpointManager(str(tmp_path / "trial"), CheckpointConfig(num_to_keep=1))
    for i in range(2):
        d = tmp_path / f"rep{i}"
        save_pytree({"i": np.array(i)}, str(d))
        manager.commit(Checkpoint(str(d)), {"i": i})
    assert int(load_pytree(manager.latest())["i"]) == 1
    assert [n for n in os.listdir(tmp_path / "trial") if n.startswith("checkpoint_")] == [
        "checkpoint_000001"]
    # a StorageContext on a local path
    ctx = _storage.StorageContext(str(tmp_path / "store"), "exp", "trial_0")
    ctx.persist_dir(copy, "checkpoint_000000")
    assert ctx.list_dir() == ["checkpoint_000000"] and ctx.exists("checkpoint_000000")
    ctx.write_json("state.json", {"a": 1})
    assert ctx.read_json("state.json") == {"a": 1}
    ctx.delete("checkpoint_000000")
    assert not ctx.exists("checkpoint_000000")


def test_a_uri_without_pyarrow_raises_import_error(no_pyarrow, tmp_path):
    for call in (lambda: Checkpoint("s3://bucket/ck"),
                 lambda: _storage.get_fs_and_path(f"file://{tmp_path}"),
                 lambda: save_pytree({"w": np.ones(2)}, f"file://{tmp_path}/ck")):
        with pytest.raises(ImportError, match="pyarrow"):
            call()
