"""Learner / LearnerGroup: the gradient-update half of the RL loop (port of
``ray_tpu/rl/learner.py``).

Reference: ``rllib/core/learner/learner.py:105`` (per-algorithm loss over an
RLModule + optimizer) and ``learner_group.py:71`` (N learner actors with
DDP-wrapped modules). A ``Learner`` drives one device, or all the local
cards it is given: the reference puts the batch over a ``("data",)`` mesh
of every local device and lets XLA reduce the gradients inside one jitted
step; here a data-parallel learner is the leader of a group of one process
per card (``rl._dp_worker`` over ``_private.local_group``): each update
cycle-pads the batch to a multiple of the ranks, as the reference does,
every rank runs the loss's backward on its contiguous slice, the gradients
are averaged over the group, and every rank applies the same clip and Adam
step, so the parameters stay identical without a broadcast.
``LearnerGroup`` places the learner in the driver or in a remote actor, or
runs N learner actors that average their shard gradients on the host (the
DDP semantics).

``data_parallel``: ``True`` (the reference's default) means every visible
card, and the group only when there is more than one; ``False`` one
device; an int N exactly N ranks through the group (on the CPU, N gloo
processes; N = 1 is the group of one).

**Whole-batch reductions.** Each rank's loss is the mean over its slice,
and the slices are equal, so averaging the ranks' gradients gives the
gradient of the mean over the whole padded batch. A loss that reduces over
rows otherwise (a normalization, a weighted mean's denominator) takes the
total over every rank from ``batch_sum``: the identity outside a
data-parallel update, a sum over the group inside one, whose gradient is
the group's sum of the ranks' gradients, so a value every rank holds alike
averages back to itself. Scalar metrics are averaged over the ranks;
per-sample arrays are gathered to the leader in row order.

Batches reach the learner's device with float64 columns as float32, as
``jnp.asarray`` makes them. A loss that draws random numbers takes them
from ``UpdateDraws`` (one place, so a test or a card-versus-CPU check can
hand it the draws), and a ``CountingLoss`` knows its update step.

The optimizer is ``torch.optim.Adam`` with ``optax.adam``'s defaults (β
0.9/0.999, ε 1e-8), behind a global-norm clip computed as
``optax.clip_by_global_norm`` does: the gradients are scaled by ``max_norm
/ norm`` only when ``norm >= max_norm`` (no ``1e-6`` in the denominator, as
``clip_grad_norm_`` adds). ``grad_norm`` is reported before the clip.

Device adaptation: ``device=None`` means the card; a remote learner asks
the runtime for ``num_gpus`` of a GPU (``GPU_SHARE`` unless set; none when
``device="cpu"``) and is bound to that share of its node's cards by its
index in the group (``accelerators.gpu.card_share_options``): given two
or more, it sees that many cards and runs data-parallel inside its actor.
Nothing here imports torch at module import: the runtime's control plane
loads this module to place learner actors.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

import numpy as np

from ray_tpu_torch.rl.sample_batch import SampleBatch


#: the GPU share a rollout engine or a remote learner on the card holds by
#: default: N rollout workers and a remote learner fit one card
GPU_SHARE = 0.25


def gpu_share(device, share: float) -> float:
    """The ``GPU`` share an actor placed for ``device`` asks the runtime for:
    ``share`` for the card (``None`` or a CUDA device), none for the CPU."""
    return 0 if str(device or "cuda").startswith("cpu") else share


def host_weights(state) -> dict:
    """``{name: np.ndarray}`` of a module or a ``{name: tensor}`` mapping with
    ONE device-to-host transfer: the tensors are flattened into one byte
    buffer on their device, copied once, and handed out as numpy views of
    it (per-tensor ``.cpu()`` would sync once per tensor). Numpy values pass
    through."""
    import torch

    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    names = list(state)
    tensors = [state[n] for n in names]
    if not any(isinstance(t, torch.Tensor) for t in tensors):
        return dict(state)
    flat = torch.cat([
        torch.as_tensor(t).detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors
    ]).cpu().numpy()
    out, off = {}, 0
    for name, t in zip(names, tensors):
        t = torch.as_tensor(t)
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        nbytes = t.numel() * t.element_size()
        out[name] = flat[off:off + nbytes].view(dtype).reshape(tuple(t.shape))
        off += nbytes
    return out


def _to_tensor(v, device):
    """A tensor on ``device``; float64 arrays arrive as float32, as
    ``jnp.asarray`` makes them with x64 off (Pendulum's rewards, JSONL
    columns)."""
    import torch

    if isinstance(v, torch.Tensor):
        return v.to(device)
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif not a.flags.writeable:  # views of the object store are read-only
        a = a.copy()
    return torch.from_numpy(a).to(device)


def tree_path(name: str) -> tuple:
    """The reference tree's path of a parameter name: ``"pi.w.0"`` →
    ``("pi", 0, "w")``, ``"log_std"`` → ``("log_std",)``."""
    parts = name.split(".")
    if len(parts) == 3:
        return parts[0], int(parts[2]), parts[1]
    return tuple(parts)


def tree_leaf(tree, name: str):
    """The reference tree's leaf under a parameter name."""
    for key in tree_path(name):
        tree = tree[key]
    return tree


def ravel_names(names) -> list:
    """Parameter names in ``jax.flatten_util.ravel_pytree``'s order of the
    reference's tree: dict keys sorted, list items in order (so each
    layer's ``"b"`` before its ``"w"``)."""
    return sorted(names, key=tree_path)


# -- data parallelism over the local cards ------------------------------------


class DataParallelUpdate:
    """The update a rank is inside: its group (``local_group.Collectives``),
    its rank of ``size``, and the padded batch's ``rows`` over all ranks
    (``rows / size`` on each)."""

    def __init__(self, coll, rank: int, size: int, rows: int):
        self.coll, self.rank, self.size, self.rows = coll, rank, size, rows

    def local_rows(self, x, dim: int = 0):
        """This rank's rows of ``x``, whose dim ``dim`` holds the whole
        batch's rows (unpadded or padded): cycle-padded to ``rows`` as the
        batch is, then this rank's contiguous slice."""
        import torch

        n = x.shape[dim]
        if n != self.rows:
            x = x.index_select(dim, torch.arange(self.rows, device=x.device) % n)
        per = self.rows // self.size
        return x.narrow(dim, self.rank * per, per)


#: the data-parallel update this thread is inside, if any (``batch_sum``,
#: ``UpdateDraws``): set by ``Learner.update_slice`` around its loss call,
#: since the losses' signature carries no group
_CURRENT = threading.local()


def _update() -> Optional[DataParallelUpdate]:
    return getattr(_CURRENT, "update", None)


def batch_sum(x):
    """``x`` summed over the ranks of a data-parallel update (every rank
    gets the total), with a gradient: the group's sum of the gradients
    flowing back. Outside an update, ``x`` itself. A loss takes every
    reduction over rows that is not a plain mean from it (see the module
    doc)."""
    if _update() is None:
        return x
    return _batch_sum_fn().apply(x)


_BATCH_SUM = None


def _batch_sum_fn():
    global _BATCH_SUM
    if _BATCH_SUM is None:
        import torch

        class _BatchSum(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                ctx.coll = _update().coll
                return ctx.coll.all_reduce(x.detach().clone())

            @staticmethod
            def backward(ctx, g):
                return ctx.coll.all_reduce(g.contiguous().clone())

        _BATCH_SUM = _BatchSum
    return _BATCH_SUM


def data_parallel_ranks(data_parallel, device) -> Optional[int]:
    """The ranks a learner on ``device`` updates over, or None for one
    device without a group: ``True`` every visible card when there is more
    than one, ``False`` none, an int exactly that many."""
    if isinstance(data_parallel, bool):
        if not data_parallel or device.type != "cuda":
            return None
        import torch

        n = torch.cuda.device_count()
        return n if n > 1 else None
    n = int(data_parallel)
    if n < 1:
        raise ValueError(f"data_parallel must be a bool or a rank count >= 1, got {data_parallel!r}")
    if device.type == "cuda":
        import torch

        visible = torch.cuda.device_count()
        if n > visible:
            raise ValueError(f"data_parallel={n} needs {n} visible cards, {visible} visible")
    return n


def pad_and_split(batch, size: int) -> tuple:
    """(each rank's contiguous slice of ``batch`` cycle-padded to a multiple
    of ``size``, as host arrays; the ``"draw/..."`` columns whole; the
    padded rows). The reference pads so (``ray_tpu/rl/learner.py:133-139``),
    also a batch smaller than ``size``."""
    arrays = {k: np.asarray(v) for k, v in batch.items()}
    draws = {k: arrays.pop(k) for k in list(arrays) if k.startswith("draw/")}
    rows = len(next(iter(arrays.values())))
    target = -(-rows // size) * size
    if target != rows:
        idx = np.arange(target) % rows
        arrays = {k: v[idx] for k, v in arrays.items()}
    per = target // size
    return [{k: v[r * per:(r + 1) * per] for k, v in arrays.items()} for r in range(size)], draws, target


class UpdateDraws:
    """The random draws of one update, taken in one place. A batch that
    carries a draw under ``"draw/<name>"`` hands it over (a test gives the
    reference's ``jax.random`` draws so; a card-versus-CPU check gives both
    sides the same); otherwise it comes from a ``torch.Generator`` on the
    batch's device seeded from ``(base, step)``, as the reference folds the
    step into ``PRNGKey(base)``. ``row_dim`` is the dim of the draw that
    runs over the batch's rows: inside a data-parallel update a draw is
    taken at the whole padded batch's shape, from the same seed on every
    rank, and each rank keeps its own rows (a handed draw is padded and
    sliced the same way)."""

    def __init__(self, base: int, step: int, batch: dict):
        self._batch = batch
        self._seed = (base << 32) + step
        self._gen = None

    def _generator(self, device):
        import torch

        if self._gen is None:
            self._gen = torch.Generator(device=device).manual_seed(self._seed)
        return self._gen

    @staticmethod
    def _global(shape: tuple, row_dim: int) -> tuple:
        update = _update()
        if update is None:
            return tuple(shape)
        shape = list(shape)
        shape[row_dim] = update.rows
        return tuple(shape)

    @staticmethod
    def _local(x, row_dim: int):
        update = _update()
        return x if update is None else update.local_rows(x, row_dim)

    def normal(self, name: str, shape: tuple, device, row_dim: int = 0):
        import torch

        got = self._batch.get(f"draw/{name}")
        if got is None:
            got = torch.randn(self._global(shape, row_dim), generator=self._generator(device), device=device)
        return self._local(got, row_dim)

    def uniform(self, name: str, shape: tuple, low, high, row_dim: int = 0):
        """Uniform in [low, high) (tensors broadcasting against ``shape``)."""
        import torch

        got = self._batch.get(f"draw/{name}")
        if got is not None:
            return self._local(got, row_dim)
        u = torch.rand(self._global(shape, row_dim), generator=self._generator(low.device), device=low.device)
        return low + (high - low) * self._local(u, row_dim)


class CountingLoss:
    """A loss that counts its calls: call n is update step n, the
    reference's ``batch["step"]`` (each update calls its learner's loss
    once), which seeds its ``UpdateDraws``."""

    step = 0

    def __call__(self, module, params, batch):
        self.step += 1
        return self.loss(params, batch, self.step)

    def loss(self, params, batch: dict, step: int):
        raise NotImplementedError


def load_weights(module, weights) -> None:
    """Copy ``{name: tensor | ndarray}`` into ``module``'s parameters (any
    device to any device)."""
    dev = next(module.parameters()).device
    module.load_state_dict({k: _to_tensor(v, dev) for k, v in weights.items()})


class Learner:
    """Owns params + optimizer state; ``update(batch)`` is one step.

    ``loss_fn(module, params, batch_dict) -> (loss, metrics_dict)`` is
    supplied by the algorithm (PPO/...); ``params`` is what
    ``module.init(generator, device)`` returned (an ``nn.Module``) and the
    batch holds tensors on the learner's device. Everything else (Adam, the
    clip, the device) is shared machinery.
    """

    def __init__(
        self,
        module_factory: Callable[[], Any],
        loss_fn: Callable,
        lr: float = 3e-4,
        grad_clip: Optional[float] = 0.5,
        seed: int = 0,
        data_parallel: bool | int = True,
        device=None,
    ):
        import torch

        from ray_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        ranks = data_parallel_ranks(data_parallel, self.device)
        self.module = module_factory()
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.module.init(self._generator, self.device)
        self._grad_clip = grad_clip
        self.opt = torch.optim.Adam(
            self.params.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8
        )
        self._loss_fn = loss_fn
        #: the followers of a data-parallel learner (``rl._dp_worker``)
        self.group = None
        if ranks is not None:
            from ray_tpu_torch.rl._dp_worker import DPGroup

            self.group = DPGroup(self, ranks, dict(module_factory=module_factory, loss_fn=loss_fn, lr=lr,
                                                   grad_clip=grad_clip, seed=seed))

    def _device_batch(self, batch: SampleBatch) -> dict:
        return {k: _to_tensor(v, self.device) for k, v in batch.items()}

    def _grads(self, batch: SampleBatch):
        """Backward of the loss on ``batch``: (loss, metrics) tensors, the
        gradients left in ``.grad``."""
        import torch

        self.opt.zero_grad(set_to_none=True)
        loss, metrics = self._loss_fn(self.module, self.params, self._device_batch(batch))
        loss.backward()
        for p in self.params.parameters():
            if p.grad is None:  # a parameter the loss does not reach: optax's zero gradient
                p.grad = torch.zeros_like(p)
        return loss, metrics

    def _global_norm(self):
        import torch

        return torch.sqrt(sum(torch.sum(p.grad.float() ** 2) for p in self.params.parameters()))

    def _clip_and_step(self):
        """``optax.chain(clip_by_global_norm(c), adam)`` on the ``.grad``s;
        returns the pre-clip global norm (a device scalar, no sync)."""
        import torch

        norm = self._global_norm()
        if self._grad_clip:
            keep = norm < self._grad_clip
            for p in self.params.parameters():
                p.grad.copy_(torch.where(keep, p.grad, p.grad / norm * self._grad_clip))
        self.opt.step()
        return norm

    @staticmethod
    def _host_metrics(metrics: dict, rows: int) -> dict:
        """ONE host transfer for every scalar metric; per-sample aux arrays
        pass through as numpy, trimmed to the batch's rows."""
        import torch

        scalars = [k for k, v in metrics.items() if torch.as_tensor(v).ndim == 0]
        out: dict = {}
        if scalars:
            stacked = torch.stack([torch.as_tensor(metrics[k]).detach().float() for k in scalars])
            for k, v in zip(scalars, stacked.cpu().tolist()):
                out[k] = float(v)
        for k, v in metrics.items():
            if k not in out:
                out[k] = torch.as_tensor(v).detach().cpu().numpy()[:rows]
        return out

    def compute_grads(self, batch: SampleBatch):
        """Gradients of the loss on this learner's batch shard, WITHOUT
        applying them — the data-parallel LearnerGroup averages shard
        grads across learners before anyone applies (reference:
        learner_group.py DDP semantics); over a group of cards, the
        group's reduced gradient. Returns ({name: np.ndarray}, metrics)."""
        if self.group is not None:
            metrics = self.group.update(batch, apply=False)
        else:
            loss, metrics = self._grads(batch)
            metrics = {"loss": loss, **metrics}
        grads = {n: p.grad for n, p in self.params.named_parameters()}
        return host_weights(grads), self._host_metrics(metrics, batch.count)

    def apply_grads(self, grads) -> bool:
        if self.group is not None:
            grads = host_weights(grads)
            self.group.apply_grads(grads)
        self._set_grads(grads)
        self._clip_and_step()
        return True

    def _set_grads(self, grads) -> None:
        named = dict(self.params.named_parameters())
        for name, g in grads.items():
            named[name].grad = _to_tensor(g, self.device)

    def update(self, batch: SampleBatch) -> dict:
        if self.group is not None:
            return self._host_metrics(self.group.update(batch, apply=True), batch.count)
        loss, metrics = self._grads(batch)
        norm = self._clip_and_step()
        return self._host_metrics({"loss": loss, "grad_norm": norm, **metrics}, batch.count)

    def update_slice(self, local: dict, draws: dict, update: DataParallelUpdate, apply: bool) -> dict:
        """One rank's part of a data-parallel update (the leader's and each
        follower's alike): the backward on its slice ``local`` (with the
        batch's draws whole), the gradients averaged over the group, the
        scalar metrics averaged and the per-sample ones gathered in row
        order; with ``apply``, the clip and the Adam step. Returns the
        metrics on the device, ``"grad_norm"`` too when applied."""
        _CURRENT.update = update
        try:
            loss, metrics = self._grads({**local, **draws})
        finally:
            _CURRENT.update = None
        self._reduce_grads(update)
        metrics = self._reduce_metrics({"loss": loss, **metrics}, update)
        if apply:
            norm = self._clip_and_step()
            metrics = {"loss": metrics.pop("loss"), "grad_norm": norm, **metrics}
        return metrics

    def _reduce_grads(self, update: DataParallelUpdate) -> None:
        """Average the ``.grad``s over the group: one all-reduce per dtype
        of one flat buffer."""
        import torch

        by_dtype: dict = {}
        for p in self.params.parameters():
            by_dtype.setdefault(p.grad.dtype, []).append(p)
        for ps in by_dtype.values():
            flat = torch.cat([p.grad.reshape(-1) for p in ps])
            update.coll.all_reduce(flat)
            if update.size > 1:
                flat.div_(update.size)
            off = 0
            for p in ps:
                p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
                off += p.numel()

    def _reduce_metrics(self, metrics: dict, update: DataParallelUpdate) -> dict:
        """Scalars averaged over the group (one all-reduce); arrays gathered
        along their first dim, in rank order (one all-gather each)."""
        import torch

        metrics = {k: torch.as_tensor(v, device=self.device).detach() for k, v in metrics.items()}
        scalars = [k for k, v in metrics.items() if v.ndim == 0]
        out = {}
        if scalars:
            stacked = update.coll.all_reduce(torch.stack([metrics[k].float() for k in scalars]))
            if update.size > 1:
                stacked.div_(update.size)
            out = dict(zip(scalars, stacked))
        for k, v in metrics.items():
            if k not in out:
                out[k] = torch.cat(update.coll.all_gather(v)) if update.size > 1 else v
        return {k: out[k] for k in metrics}

    def get_weights(self) -> dict:
        """``{name: tensor}`` on the learner's device: a snapshot, as the
        reference's tree of immutable arrays is. The optimizer and the
        target syncs write the parameters in place, so this is a clone."""
        return {k: v.detach().clone() for k, v in self.params.state_dict().items()}

    def weights_view(self) -> dict:
        """The live ``{name: tensor}`` (no copy), for a caller that reads it
        at once (a runner sync, a weight publish): held across an update it
        follows the weights."""
        return {k: v.detach() for k, v in self.params.state_dict().items()}

    def get_host_weights(self) -> dict:
        """``{name: np.ndarray}``, one device-to-host transfer."""
        return host_weights(self.params)

    def set_weights(self, params) -> bool:
        if self.group is not None:
            params = host_weights(params)
            self.group.set_weights(params)
        load_weights(self.params, params)
        return True

    def apply(self, fn: Callable, *args) -> Any:
        """Run an arbitrary function against (learner, *args) — the remote
        escape hatch LearnerGroup uses for target-net sync etc. A
        data-parallel learner runs it on every rank (its followers get
        ``fn`` and ``args`` by cloudpickle) and returns the leader's
        result."""
        if self.group is not None:
            self.group.apply(fn, args)
        return fn(self, *args)

    def close(self) -> None:
        """Stop a data-parallel learner's followers (idempotent; also at
        collection)."""
        if self.group is not None:
            self.group.close()


class LearnerGroup:
    """Places the Learner locally or in a remote actor.

    Reference: ``rllib/core/learner/learner_group.py:71``. ``remote=True``
    puts the learner in its own process so env runners and the driver never
    contend with the update stream. A remote learner on the card holds
    ``num_gpus`` of a GPU (default ``GPU_SHARE``, so it shares one card with
    rollout engines); ``learner_kwargs["device"] == "cpu"`` asks for none.
    """

    def __init__(
        self,
        learner_kwargs: dict,
        remote: bool = False,
        num_cpus: float = 1,
        num_learners: int = 1,
        num_gpus: Optional[float] = None,
    ):
        self._remote = remote or num_learners > 1
        self._actors: list = []
        gpus = gpu_share(learner_kwargs.get("device"), GPU_SHARE if num_gpus is None else num_gpus)
        if self._remote:
            # data-parallel learners (reference: learner_group.py:71 N
            # DDP-wrapped learners): every learner initializes IDENTICAL
            # params from the shared seed, each update computes gradients
            # on its batch shard, the group averages (sample-weighted) and
            # every learner applies the SAME averaged update — weights stay
            # bit-identical across learners, exactly like DDP.
            import ray_tpu_torch
            from ray_tpu_torch.accelerators.gpu import card_share_options

            cls = ray_tpu_torch.remote(Learner)
            self._actors = [
                cls.options(num_cpus=num_cpus, **card_share_options(i, gpus)).remote(**learner_kwargs)
                for i in range(max(num_learners, 1))
            ]
            self._actor = self._actors[0]
            self._local = None
        else:
            self._actor = None
            self._local = Learner(**learner_kwargs)

    def update(self, batch: SampleBatch) -> dict:
        if self._local is not None:
            return self._local.update(batch)
        import ray_tpu_torch

        if len(self._actors) > 1:
            return self._update_data_parallel(batch)
        return ray_tpu_torch.get(self._actor.update.remote(batch))

    def _update_data_parallel(self, batch: SampleBatch) -> dict:
        import ray_tpu_torch

        k = len(self._actors)
        n = batch.count
        bounds = [round(i * n / k) for i in range(k + 1)]
        # a 0-row shard would mean a loss over zero elements → NaN grads
        # that no zero weight can neutralize (0·NaN = NaN): only learners
        # with actual rows compute this round; EVERY learner still applies
        # the same averaged update (lockstep invariant)
        work = [
            (a, batch.slice(lo, hi), (hi - lo) / max(n, 1))
            for a, lo, hi in zip(self._actors, bounds, bounds[1:])
            if hi > lo
        ]
        results = ray_tpu_torch.get([a.compute_grads.remote(s) for a, s, _w in work])
        weights = [w for _a, _s, w in work]
        # sample-weighted average == the full-batch gradient of a mean loss
        avg = {
            name: sum(w * g[name] for w, (g, _m) in zip(weights, results))
            for name in results[0][0]
        }
        ray_tpu_torch.get([a.apply_grads.remote(avg) for a in self._actors])
        metrics: dict = {}
        arrays: dict = {}
        for w, (_g, m) in zip(weights, results):
            for key, v in m.items():
                if np.ndim(v) == 0:
                    metrics[key] = metrics.get(key, 0.0) + w * float(v)
                else:
                    arrays.setdefault(key, []).append(v)
        for key, parts in arrays.items():
            # per-sample aux re-assembles in shard order
            metrics[key] = np.concatenate(parts)
        return metrics

    def get_weights(self):
        """The local learner's ``{name: tensor}`` on its device, a snapshot
        (``Learner.get_weights``); a remote learner's ``{name: np.ndarray}``
        (one transfer in the actor)."""
        if self._local is not None:
            return self._local.get_weights()
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.get_host_weights.remote())

    def weights_view(self):
        """``get_weights`` without the local learner's copy
        (``Learner.weights_view``), for callers that read the weights at
        once; a remote learner's weights come as host arrays either way."""
        if self._local is not None:
            return self._local.weights_view()
        return self.get_weights()

    def set_weights(self, params):
        if self._local is not None:
            return self._local.set_weights(params)
        import ray_tpu_torch

        # all learners must stay in lockstep (DDP invariant)
        params = host_weights(params)
        return ray_tpu_torch.get([a.set_weights.remote(params) for a in self._actors])[0]

    def apply(self, fn: Callable, *args):
        if self._local is not None:
            return self._local.apply(fn, *args)
        import ray_tpu_torch

        # e.g. target-net sync: runs on EVERY learner; rank0's result returns
        return ray_tpu_torch.get([a.apply.remote(fn, *args) for a in self._actors])[0]

    def shutdown(self):
        import ray_tpu_torch
        from ray_tpu_torch._private.log_util import warn_throttled

        if self._local is not None:
            self._local.close()
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception as e:
                # best-effort teardown, but not silent: a failed kill here
                # is a leaked learner actor holding its device allocation
                warn_throttled("rl learner group teardown", e)
