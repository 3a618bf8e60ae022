"""Learner / LearnerGroup: the gradient-update half of the RL loop (port of
``ray_tpu/rl/learner.py``).

Reference: ``rllib/core/learner/learner.py:105`` (per-algorithm loss over an
RLModule + optimizer) and ``learner_group.py:71`` (N learner actors with
DDP-wrapped modules). A ``Learner`` drives one device; ``LearnerGroup``
places it in the driver or in a remote actor, or runs N learner actors that
average their shard gradients on the host (the DDP semantics). The
reference's ``data_parallel`` mesh over several local devices is not
ported (ROADMAP.md, queue A8): with more than one card visible a
``data_parallel`` learner raises.

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
index in the group (``accelerators.gpu.card_share_options``).
Nothing here imports torch at module import: the runtime's control plane
loads this module to place learner actors.
"""

from __future__ import annotations

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


class UpdateDraws:
    """The random draws of one update, taken in one place. A batch that
    carries a draw under ``"draw/<name>"`` hands it over (a test gives the
    reference's ``jax.random`` draws so; a card-versus-CPU check gives both
    sides the same); otherwise it comes from a ``torch.Generator`` on the
    batch's device seeded from ``(base, step)``, as the reference folds the
    step into ``PRNGKey(base)``."""

    def __init__(self, base: int, step: int, batch: dict):
        self._batch = batch
        self._seed = (base << 32) + step
        self._gen = None

    def _generator(self, device):
        import torch

        if self._gen is None:
            self._gen = torch.Generator(device=device).manual_seed(self._seed)
        return self._gen

    def normal(self, name: str, shape: tuple, device):
        import torch

        got = self._batch.get(f"draw/{name}")
        if got is not None:
            return got
        return torch.randn(shape, generator=self._generator(device), device=device)

    def uniform(self, name: str, shape: tuple, low, high):
        """Uniform in [low, high) (tensors broadcasting against ``shape``)."""
        import torch

        got = self._batch.get(f"draw/{name}")
        if got is not None:
            return got
        u = torch.rand(shape, generator=self._generator(low.device), device=low.device)
        return low + (high - low) * u


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
        data_parallel: bool = True,
        device=None,
    ):
        import torch

        from ray_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        if data_parallel and self.device.type == "cuda" and torch.cuda.device_count() > 1:
            raise NotImplementedError(
                f"a data-parallel learner over {torch.cuda.device_count()} cards is not ported "
                "yet (ROADMAP.md, queue A8): make the learner see one card, or use "
                "LearnerGroup(num_learners=N)"
            )
        self.module = module_factory()
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.module.init(self._generator, self.device)
        self._grad_clip = grad_clip
        self.opt = torch.optim.Adam(
            self.params.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8
        )
        self._loss_fn = loss_fn

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
        learner_group.py DDP semantics). Returns ({name: np.ndarray},
        metrics)."""
        loss, metrics = self._grads(batch)
        grads = {n: p.grad for n, p in self.params.named_parameters()}
        host = self._host_metrics({"loss": loss, **metrics}, batch.count)
        return host_weights(grads), host

    def apply_grads(self, grads) -> bool:
        named = dict(self.params.named_parameters())
        for name, g in grads.items():
            named[name].grad = _to_tensor(g, self.device)
        self._clip_and_step()
        return True

    def update(self, batch: SampleBatch) -> dict:
        loss, metrics = self._grads(batch)
        norm = self._clip_and_step()
        return self._host_metrics({"loss": loss, "grad_norm": norm, **metrics}, batch.count)

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
        load_weights(self.params, params)
        return True

    def apply(self, fn: Callable, *args) -> Any:
        """Run an arbitrary function against (learner, *args) — the remote
        escape hatch LearnerGroup uses for target-net sync etc."""
        return fn(self, *args)


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

        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception as e:
                # best-effort teardown, but not silent: a failed kill here
                # is a leaked learner actor holding its device allocation
                warn_throttled("rl learner group teardown", e)
