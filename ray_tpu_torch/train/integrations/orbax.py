"""Sharded pytree checkpoints (port of
``ray_tpu/train/integrations/orbax.py``).

The reference writes pytrees of sharded arrays with orbax; the port writes
nested dicts of tensors — ``DTensor`` shards included — with
``torch.distributed.checkpoint`` (DCP). The files are DCP's, not orbax's:
under the reference's ``pytree/`` subdirectory each rank writes its own
shards (``__<rank>_0.distcp``) and rank 0 the ``.metadata``. A restore
with ``target=`` loads into the target's tensors in place, whatever their
placement, another mesh included (DCP reshards by each shard's global
offsets): a tensor whose layout depends on the mesh must be saved in a
layout that does not. ``parallel.train_step.train_state_dict`` turns a
``TrainState`` into such a dict (the fused qkv's tp order undone by a view)
and, as a target, restores one in place. These helpers bridge DCP
directories and ``ray_tpu_torch.train.Checkpoint``, so
``session.report(checkpoint=...)`` can carry sharded model state.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint

_SUBDIR = "pytree"


def _dcp_kwargs() -> dict:
    """Outside a process group DCP runs as one process (no collectives)."""
    import torch.distributed as dist

    return {} if dist.is_available() and dist.is_initialized() else {"no_dist": True}


def save_pytree_checkpoint(state: Any, path: str) -> Checkpoint:
    """Write ``state`` (a nested dict of tensors, ``DTensor``s and plain
    values) to ``path`` with DCP and return a train ``Checkpoint`` handle
    for ``session.report``. Every rank of a process group calls it with the
    same path. ``path`` may be a pyarrow.fs URI — DCP writes to a local
    stage and the result is uploaded through the storage layer."""
    import torch.distributed.checkpoint as dcp

    from ray_tpu_torch.train import _storage

    if _storage.is_uri(path):
        import tempfile

        with tempfile.TemporaryDirectory(prefix="dcp_stage_") as stage:
            save_pytree_checkpoint(state, stage)
            return Checkpoint(stage).to_uri(path)

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    dcp.save(state, checkpoint_id=os.path.join(path, _SUBDIR), **_dcp_kwargs())
    return Checkpoint.from_directory(path)


def _target_from_metadata(item: str) -> dict:
    """A nested dict of empty CPU tensors (and placeholders for the plain
    values) shaped as the checkpoint at ``item``, for a restore without a
    target."""
    import torch
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    meta = FileSystemReader(item).read_metadata()
    paths = meta.planner_data or {}
    out: dict = {}
    for key, md in meta.state_dict_metadata.items():
        value = (torch.empty(md.size, dtype=md.properties.dtype)
                 if isinstance(md, TensorStorageMetadata) else None)
        node = out
        path = paths.get(key, (key,))
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return out


def load_pytree_checkpoint(checkpoint: "Checkpoint | str", target: Optional[Any] = None) -> Any:
    """Restore a tree saved by :func:`save_pytree_checkpoint`.

    ``target`` (a nested dict of like-shaped tensors or ``DTensor``s, e.g.
    a freshly sharded train state's ``train_state_dict``) is loaded in
    place, with its structure and placements, and returned; without it the
    saved tree comes back as CPU tensors and plain values."""
    import torch.distributed.checkpoint as dcp

    if isinstance(checkpoint, str):
        checkpoint = Checkpoint(checkpoint)
    with checkpoint.as_directory() as path:
        item = os.path.join(os.path.abspath(path), _SUBDIR)
        state = target if target is not None else _target_from_metadata(item)
        dcp.load(state, checkpoint_id=item, **_dcp_kwargs())
        return state
