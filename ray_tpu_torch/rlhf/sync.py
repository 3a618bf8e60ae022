"""Versioned learner→engine weight sync over the object plane (port of
``ray_tpu/rlhf/sync.py``).

The disaggregated async-RL wiring (LlamaRL / MindSpeed RL shape): the
learner PUBLISHES a ``WeightUpdate`` — the policy's parameters copied to
the host and chunked through ``ray_tpu_torch.put`` — and every rollout
engine APPLIES it between ``step()`` iterations via
``LLMEngine.update_weights``, without draining in-flight generation.
Publication and application are deliberately decoupled:

* ``publish_weights`` runs once per learner step on the driver/learner
  side: ONE device-to-host transfer for the whole module (the tensors are
  flattened into one buffer on the card; a ``.cpu()`` per tensor would
  sync once per tensor), then greedy chunking in ``state_dict`` order so
  each object stays under ``chunk_bytes``. Each chunk is a list of numpy
  arrays, which the object plane stores out of band and a same-node
  ``get`` reads without a copy; the SAME refs fan out to every engine.
* ``apply_weight_update`` runs inside each consumer (rollout actor OR
  serve replica — ``serve.llm.LLMDeployment.update_weights`` calls this
  exact function) and is the only place that fetches the chunks.

Where the reference's manifest carries a pytree's treedef, this one carries
the ``state_dict`` names in order. Every trajectory an engine generates is
stamped with the engine's ``weights_version`` at submit; the learner's
staleness gate (``rlhf.algorithm``) compares those stamps against its own
version.

Observability: ``rlhf.sync.push`` / ``rlhf.sync.apply`` flight-recorder
events carry version + latency; ``rlhf_sync_seconds{phase=...}`` and
``rlhf_sync_bytes`` make push/apply cost visible. Nothing here imports
torch at module import.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from ray_tpu_torch._private import events as _events
from ray_tpu_torch.rlhf.metrics import rlhf_metrics


@dataclasses.dataclass
class WeightUpdate:
    """One published parameter version. Pickles small: the arrays live in
    the object store behind ``chunk_refs``; this manifest carries only
    the version, the parameter names, and the refs."""

    version: int
    names: list                  # the policy's state_dict names, in order
    chunk_refs: list             # ObjectRefs, each -> list[np.ndarray]
    chunk_sizes: list            # arrays per chunk (reassembly check)
    nbytes: int
    created_t: float

    @property
    def num_leaves(self) -> int:
        return sum(self.chunk_sizes)


def publish_weights(params, version: int, chunk_bytes: int = 8 << 20) -> WeightUpdate:
    """Copy ``params`` (an ``nn.Module`` or ``{name: tensor | ndarray}``) to
    the host in one transfer and put it into the object plane as ≤
    ``chunk_bytes`` chunks, greedily in name order."""
    import ray_tpu_torch
    from ray_tpu_torch.rl.learner import host_weights

    t0 = time.perf_counter()
    host = host_weights(params)

    chunk_refs: list = []
    chunk_sizes: list = []
    cur: list = []
    cur_bytes = 0
    total = 0
    for leaf in host.values():
        total += leaf.nbytes
        if cur and cur_bytes + leaf.nbytes > chunk_bytes:
            chunk_refs.append(ray_tpu_torch.put(cur))
            chunk_sizes.append(len(cur))
            cur, cur_bytes = [], 0
        cur.append(leaf)
        cur_bytes += leaf.nbytes
    if cur:
        chunk_refs.append(ray_tpu_torch.put(cur))
        chunk_sizes.append(len(cur))

    push_s = time.perf_counter() - t0
    m = rlhf_metrics()
    m["sync_s"].observe(push_s, tags={"phase": "push"})
    m["sync_bytes"].inc(total)
    m["version"].set(version)
    _events.record(
        "rlhf.sync.push", version=version, chunks=len(chunk_refs),
        bytes=total, push_s=round(push_s, 6),
    )
    return WeightUpdate(
        version=version, names=list(host), chunk_refs=chunk_refs,
        chunk_sizes=chunk_sizes, nbytes=total, created_t=time.time(),
    )


def fetch_params(update: WeightUpdate, timeout: Optional[float] = 120.0) -> dict:
    """Materialize the published ``{name: np.ndarray}`` (one batched get for
    all chunks; the arrays are read-only views of the store)."""
    import ray_tpu_torch

    chunks = ray_tpu_torch.get(list(update.chunk_refs), timeout=timeout)
    leaves: list = []
    for chunk, expect in zip(chunks, update.chunk_sizes):
        if len(chunk) != expect:
            raise ValueError(
                f"weight chunk carries {len(chunk)} leaves, manifest says "
                f"{expect} (object-plane corruption or version skew)"
            )
        leaves.extend(chunk)
    if len(leaves) != len(update.names):
        raise ValueError(
            f"weight chunks carry {len(leaves)} leaves, the manifest names {len(update.names)}"
        )
    return dict(zip(update.names, leaves))


def _host_tensors(params: dict) -> dict:
    """numpy arrays → CPU tensors sharing their memory (the engine only
    reads them, copying each into its own parameter storage)."""
    import warnings

    import numpy as np
    import torch

    out = {}
    with warnings.catch_warnings():
        # store views are read-only; nothing writes through these tensors
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        for name, a in params.items():
            out[name] = torch.from_numpy(np.asarray(a)) if not isinstance(a, torch.Tensor) else a
    return out


def apply_weight_update(
    engine, update, timeout: Optional[float] = 120.0
) -> int:
    """Fetch + hot-swap one engine. ``update`` is a ``WeightUpdate`` (the
    normal push path) or a ``(params, version)`` tuple, ``params`` a module
    or ``{name: tensor | ndarray}`` (tests / local engines that skip the
    object plane). Returns the installed version; a version the engine
    already has (duplicate delivery, e.g. a retried push) is applied
    idempotently — ``LLMEngine.update_weights`` only rejects going
    BACKWARDS."""
    t0 = time.perf_counter()
    if isinstance(update, WeightUpdate):
        params, version = fetch_params(update, timeout=timeout), update.version
    else:
        params, version = update
    if isinstance(params, dict):
        params = _host_tensors(params)
    installed = engine.update_weights(params, version)
    apply_s = time.perf_counter() - t0
    m = rlhf_metrics()
    m["sync_s"].observe(apply_s, tags={"phase": "apply"})
    _events.record(
        "rlhf.sync.apply", version=installed,
        apply_s=round(apply_s, 6),
        in_flight=engine.stats().get("running", 0),
    )
    return installed
