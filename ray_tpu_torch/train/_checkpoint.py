"""Checkpoint: a directory handle with metadata, local or on ``pyarrow.fs``
(copy of ``ray_tpu/train/_checkpoint.py``).

Reference: ``python/ray/train/_checkpoint.py:56`` — a Checkpoint is a
directory on a filesystem, never a live object graph; frameworks serialize
into it. ``from_uri/to_uri`` mirror the reference's cloud round-trip (and
need pyarrow, ``_storage``).

``save_pytree``/``load_pytree`` write and read the reference's files:
``pytree.npz`` (``leaf_<i>`` arrays) and ``treedef.json`` (``n_leaves``,
``step``), with the leaves numbered in JAX's order (dict keys sorted). The
reference pickles a JAX treedef beside them; here the tree's structure goes
into ``treedef.json`` instead (nested dicts with str or int keys, lists,
tuples and JSON scalars), which is what a module's and an optimizer's
``state_dict()`` hold. ``save_state``/``load_state`` keep a
``parallel.train_step.TrainState`` that way.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import zipfile
from typing import Any, Iterator, Optional

import numpy as np

from ray_tpu_torch.train import _storage

_METADATA_FILE = ".ray_tpu_checkpoint.json"
_SCALARS = (type(None), bool, int, float, str)


class Checkpoint:
    """A handle to a checkpoint directory.

    ``path`` may be a local directory, a URI (``s3://…``, ``gs://…``,
    ``file:///…``), or an fs-internal path paired with an explicit
    ``filesystem`` (reference: ``Checkpoint(path, filesystem)``).
    """

    def __init__(self, path: str, filesystem=None):
        if filesystem is None and not _storage.is_uri(path):
            self.path = os.path.abspath(path)
            self.filesystem = None
            self._fs_path = self.path
        else:
            self.path = str(path)
            fs, fs_path = _storage.get_fs_and_path(path, filesystem)
            self.filesystem = fs
            self._fs_path = fs_path

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_uri(cls, uri: str) -> "Checkpoint":
        """Handle to a checkpoint already persisted at ``uri``
        (reference: ``Checkpoint.from_uri``)."""
        return cls(uri)

    def to_uri(self, uri: str) -> "Checkpoint":
        """Upload this (local) checkpoint to ``uri`` and return the remote
        handle (reference: ``Checkpoint.to_uri``)."""
        fs, fs_path = _storage.get_fs_and_path(uri)
        with self.as_directory() as local:
            _storage.upload_dir(fs, fs_path, local)
        return Checkpoint(uri)

    # -- local access ------------------------------------------------------
    @property
    def _is_remote(self) -> bool:
        if _storage.is_local(self.filesystem):
            return False  # purely local flows never import pyarrow
        pafs = _storage.pyarrow_fs()
        return not isinstance(self.filesystem, pafs.LocalFileSystem)

    def to_directory(self, path: Optional[str] = None) -> str:
        """Copy checkpoint contents into ``path`` (or a fresh temp dir)."""
        dest = path or tempfile.mkdtemp(prefix="ckpt_")
        os.makedirs(dest, exist_ok=True)
        if self._is_remote:
            _storage.download_dir(self.filesystem, self._fs_path, dest)
        else:
            shutil.copytree(self._fs_path, dest, dirs_exist_ok=True)
        return dest

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        """Yield a local directory with the checkpoint contents. Local
        checkpoints are yielded as-is (zero-copy); remote ones download to a
        temp dir that is removed afterwards."""
        if not self._is_remote:
            yield self._fs_path
            return
        dest = self.to_directory()
        try:
            yield dest
        finally:
            shutil.rmtree(dest, ignore_errors=True)

    # -- metadata ----------------------------------------------------------
    def get_metadata(self) -> dict:
        if self._is_remote:
            meta = _storage.fs_join(self._fs_path, _METADATA_FILE)
            if _storage.exists(self.filesystem, meta):
                return _storage.read_json(self.filesystem, meta)
            return {}
        f = os.path.join(self._fs_path, _METADATA_FILE)
        if os.path.exists(f):
            with open(f) as fp:
                return json.load(fp)
        return {}

    def set_metadata(self, metadata: dict) -> None:
        if self._is_remote:
            _storage.write_json(
                self.filesystem, _storage.fs_join(self._fs_path, _METADATA_FILE), metadata
            )
            return
        with open(os.path.join(self._fs_path, _METADATA_FILE), "w") as fp:
            json.dump(metadata, fp)

    def update_metadata(self, metadata: dict) -> None:
        m = self.get_metadata()
        m.update(metadata)
        self.set_metadata(m)

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"

    def __eq__(self, other):
        return isinstance(other, Checkpoint) and other.path == self.path

    def __hash__(self):
        return hash(self.path)


# ---------------------------------------------------------------------------
# trees of arrays
# ---------------------------------------------------------------------------


def _to_numpy(x) -> np.ndarray:
    """A leaf as a host array. bf16 (which numpy lacks) widens to fp32,
    which holds every bf16 value exactly."""
    if isinstance(x, np.ndarray):
        return x
    import torch

    t = x.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _is_leaf(x) -> bool:
    if isinstance(x, np.ndarray):
        return True
    import sys

    torch = sys.modules.get("torch")  # a tensor leaf means torch is loaded
    return torch is not None and isinstance(x, torch.Tensor)


def _flatten(tree, leaves: list):
    """The JSON structure of ``tree``, appending its array leaves."""
    if _is_leaf(tree):
        leaves.append(tree)
        return {"leaf": len(leaves) - 1}
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, (str, int)) or isinstance(k, bool):
                raise TypeError(f"save_pytree takes str or int dict keys, got {k!r}")
        try:  # JAX's order, so the leaves are numbered as the reference numbers them
            keys = sorted(tree)
        except TypeError:  # str and int keys in one dict
            keys = list(tree)
        return {"dict": [[k, _flatten(tree[k], leaves)] for k in keys]}
    if isinstance(tree, (list, tuple)) and type(tree) in (list, tuple):
        return {type(tree).__name__: [_flatten(v, leaves) for v in tree]}
    if isinstance(tree, _SCALARS):
        return {"value": tree}
    if isinstance(tree, np.generic):
        return {"value": tree.item()}
    raise TypeError(f"save_pytree cannot store a {type(tree).__name__}")


def _unflatten(node, leaves: list):
    if "leaf" in node:
        return leaves[node["leaf"]]
    if "dict" in node:
        return {k: _unflatten(v, leaves) for k, v in node["dict"]}
    if "list" in node:
        return [_unflatten(v, leaves) for v in node["list"]]
    if "tuple" in node:
        return tuple(_unflatten(v, leaves) for v in node["tuple"])
    return node["value"]


def save_pytree(tree: Any, path: str, *, step: Optional[int] = None) -> Checkpoint:
    """Serialize a tree of arrays into ``path`` and return a Checkpoint.

    Leaves are ``torch.Tensor``s on any device or numpy arrays; each is
    copied to the host and written to ``pytree.npz`` one at a time, so the
    host never holds more than one leaf's copy. ``path`` may be a URI: the
    tree is staged locally and uploaded.
    """
    if _storage.is_uri(path):
        with tempfile.TemporaryDirectory(prefix="ckpt_stage_") as stage:
            save_pytree(tree, stage, step=step)
            return Checkpoint(stage).to_uri(path)

    os.makedirs(path, exist_ok=True)
    leaves: list = []
    structure = _flatten(tree, leaves)
    # np.savez's layout (one stored .npy member per leaf), written leaf by leaf
    with zipfile.ZipFile(os.path.join(path, "pytree.npz"), "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, leaf in enumerate(leaves):
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asarray(_to_numpy(leaf)), allow_pickle=False)
    with open(os.path.join(path, "treedef.json"), "w") as fp:
        json.dump({"n_leaves": len(leaves), "step": step, "structure": structure}, fp)
    ckpt = Checkpoint(path)
    if step is not None:
        ckpt.update_metadata({"step": step})
    return ckpt


def load_pytree(checkpoint: "Checkpoint | str") -> Any:
    """Inverse of :func:`save_pytree`; leaves come back as numpy arrays
    (placing them on a device is the caller's job). Accepts a Checkpoint
    (local or remote), a local path, or a URI."""
    if isinstance(checkpoint, str):
        checkpoint = Checkpoint(checkpoint)
    with checkpoint.as_directory() as path:
        with open(os.path.join(path, "treedef.json")) as fp:
            meta = json.load(fp)
        if "structure" not in meta:
            raise ValueError(
                f"{path}: treedef.json holds no tree structure (a checkpoint written by "
                "another package's save_pytree?)"
            )
        with np.load(os.path.join(path, "pytree.npz")) as data:
            leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    return _unflatten(meta["structure"], leaves)


# ---------------------------------------------------------------------------
# train states (parallel.train_step.TrainState)
# ---------------------------------------------------------------------------


def save_state(state, path: str) -> Checkpoint:
    """Save a ``TrainState``: the module's ``state_dict()``, the optimizer's
    ``state_dict()`` and ``step``, as one tree (``save_pytree``), with
    ``step`` in the metadata."""
    tree = {
        "params": state.params.state_dict(),
        "opt_state": state.opt_state.state_dict(),
        "step": int(state.step),
    }
    return save_pytree(tree, path, step=int(state.step))


def _tensors(tree):
    import torch

    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_tensors(v) for v in tree)
    return tree


def load_state(checkpoint: "Checkpoint | str", state):
    """Rebuild a saved ``TrainState`` on ``state``: a state of the same
    model and optimizer (``init_fn`` of ``build_train_step`` on a model of
    the same config), whose parameters and optimizer state are overwritten
    in place on their devices. Returns it with the saved ``step``, ready for
    ``step_fn`` to continue from."""
    tree = load_pytree(checkpoint)
    state.params.load_state_dict(_tensors(tree["params"]))
    state.opt_state.load_state_dict(_tensors(tree["opt_state"]))
    return state._replace(step=int(tree["step"]))
