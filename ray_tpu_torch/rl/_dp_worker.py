"""The data-parallel learner's group (``rl.learner.Learner`` with
``data_parallel`` over several ranks): the leader's ``DPGroup`` and the
follower loop, over ``_private.local_group`` (one process a card, a
private process group, a pipe of commands to each follower, heartbeats).

The learner's process is rank 0 on its card; ``DPGroup`` starts ``size -
1`` followers on the next cards, each a fresh interpreter running this
module's ``main``. The first command hands a follower the learner's
arguments by cloudpickle (the module factory and the loss are the
algorithm's closures); it builds a plain one-device ``Learner`` from them
and receives rank 0's parameters by broadcast, so every rank starts from
the same weights. Each update the leader pads and splits the batch
(``learner.pad_and_split``) and sends every follower its slice as host
arrays; then every rank runs ``Learner.update_slice``, whose collectives
(the gradients' and metrics' reductions, ``batch_sum`` in the losses) keep
the ranks in step. ``set_weights``, ``apply_grads`` and ``apply`` reach
every rank the same way. A follower that fails exits, and the leader's
next collective or command raises naming its rank.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import weakref

from ray_tpu_torch._private.local_group import Follower, LocalGroup, pack_bytes, traced

OP_INIT, OP_UPDATE, OP_APPLY_GRADS, OP_SET_WEIGHTS, OP_APPLY, OP_REPORT, OP_TRACE = range(1, 8)


def _dumps(obj) -> bytes:
    return pickle.dumps(obj, protocol=5)


def learner_report(learner) -> dict:
    """What a rank reports of itself: a digest of its parameters' bytes
    (equal on every rank after any update) and its flash kernels' launches
    so far (K3/K4/K5, a GPT policy on the card)."""
    from ray_tpu_torch.ops.flash_attention import flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_fwd_cuda
    from ray_tpu_torch.rl.learner import host_weights

    digest = hashlib.sha256()
    for name, v in sorted(host_weights(learner.params).items()):
        digest.update(name.encode())
        digest.update(v.tobytes())
    return dict(params_sha256=digest.hexdigest(),
                flash=[flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches])


class DPGroup(LocalGroup):
    """The leader's side of a data-parallel learner: ``size`` ranks, the
    learner's process rank 0 on the learner's device. ``kwargs`` are the
    learner's own arguments, which each follower rebuilds its learner
    from."""

    ROLE = "dp follower"

    def __init__(self, learner, size: int, kwargs: dict):
        import cloudpickle

        super().__init__(size, learner.device, "ray_tpu_torch.rl._dp_worker", {}, name="data_parallel")
        # weak: the learner owns the group, and its collection stops the
        # followers (``LocalGroup``'s finalizer)
        self._learner = weakref.ref(learner)
        try:
            self.send([pack_bytes(OP_INIT, (), cloudpickle.dumps(kwargs))] * len(self.procs))
            self.guarded(lambda: [self.coll.broadcast(p.data) for p in learner.params.parameters()])
        except BaseException:
            self.close()
            raise

    def update(self, batch, apply: bool) -> dict:
        """One data-parallel update of ``batch`` (with ``apply``, the clip
        and Adam step too): the leader's metrics on its device."""
        from ray_tpu_torch.rl.learner import DataParallelUpdate, pad_and_split

        slices, draws, rows = pad_and_split(batch, self.size)
        self.send([pack_bytes(OP_UPDATE, (int(apply), rows), _dumps((s, draws))) for s in slices[1:]])
        update = DataParallelUpdate(self.coll, 0, self.size, rows)
        return self.guarded(lambda: self._learner().update_slice(slices[0], draws, update, apply))

    def apply_grads(self, grads: dict) -> None:
        self.send([pack_bytes(OP_APPLY_GRADS, (), _dumps(grads))] * len(self.procs))

    def set_weights(self, weights: dict) -> None:
        self.send([pack_bytes(OP_SET_WEIGHTS, (), _dumps(weights))] * len(self.procs))

    def apply(self, fn, args: tuple) -> None:
        import cloudpickle

        self.send([pack_bytes(OP_APPLY, (), cloudpickle.dumps((fn, args)))] * len(self.procs))

    def reports(self) -> list[dict]:
        """Every rank's ``learner_report``, the leader's first."""
        self.send([pack_bytes(OP_REPORT)] * len(self.procs))
        return [learner_report(self._learner())] + self.replies("report")

    def trace_next_update(self) -> None:
        """Have each follower run its next command under the profiler; after
        it, ``replies("trace")`` gives each one's host time and device busy
        time (``local_group.traced``)."""
        self.send([pack_bytes(OP_TRACE)] * len(self.procs))


def main(argv=None) -> None:
    channel = Follower(argv)
    spec = channel.spec

    import torch

    from ray_tpu_torch._private.local_group import Collectives, make_group
    from ray_tpu_torch.rl.learner import DataParallelUpdate, Learner

    dev = channel.set_device()
    channel.send("hello", pid=os.getpid())
    _, pg = make_group(spec["backend"], spec["port"], spec["rank"], spec["size"])
    coll = Collectives(pg)
    learner = None
    trace = False
    for op, fields, body in channel.commands():
        if op == OP_INIT:
            kwargs = pickle.loads(body)
            learner = Learner(**kwargs, data_parallel=False, device=dev)
            with torch.no_grad():
                for p in learner.params.parameters():
                    coll.broadcast(p.data)
            continue
        if op == OP_TRACE:
            trace = True  # the next command runs under the profiler
            continue

        def run(op=op, fields=fields, body=body):
            if op == OP_UPDATE:
                local, draws = pickle.loads(body)
                learner.update_slice(local, draws, DataParallelUpdate(coll, spec["rank"], spec["size"], fields[1]),
                                     bool(fields[0]))
            elif op == OP_APPLY_GRADS:
                learner._set_grads(pickle.loads(body))
                learner._clip_and_step()
            elif op == OP_SET_WEIGHTS:
                from ray_tpu_torch.rl.learner import load_weights

                load_weights(learner.params, pickle.loads(body))
            elif op == OP_APPLY:
                fn, args = pickle.loads(body)
                fn(learner, *args)
            elif op == OP_REPORT:
                return learner_report(learner)
            else:
                raise ValueError(f"unknown data-parallel command {op}")
            return None

        if trace:
            channel.send("trace", **traced(run, dev))
            trace = False
            continue
        out = run()
        if out is not None:
            channel.send("report", **out)
