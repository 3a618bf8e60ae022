"""Streaming executor: runs a logical plan as a pipeline of remote tasks
(port of ``ray_tpu/data/execution.py`` over the port's runtime).

Reference: ``python/ray/data/_internal/execution/streaming_executor.py:55``
(scheduling loop :241), ``streaming_executor_state.py:360,501``
(backpressure-aware operator selection), ``operators/map_operator.py``
(task/actor pools), and the push-based shuffle in ``planner/exchange/``.

Design: physical operators form a tree (Union/Zip have several inputs).
Each map bundle is ONE remote task returning TWO objects — the block list
(stays remote) and its metadata list (small, fetched by the driver to make
scheduling and limit/split decisions without touching data). All-to-all ops
(shuffle/sort/repartition/groupby) are two-stage map/reduce exchanges using
``num_returns=P`` partitioned map outputs, so reducers fetch exactly their
partition — the counterpart of the reference's exchange operators.

Blocks are numpy dicts. A task's input blocks are zero-copy views of the
object store, and a block it hands back may be a view (a row slice) of one
of them: the runtime serializes a task's return value into the store when
the task returns (and ``put`` does so at once), so the copy the reference got
from Arrow owning its buffers happens there, and no task hands back a live
view of memory its worker later releases.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import plan as L
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data.context import DataContext


@dataclass
class RefBundle:
    """A unit of streaming: one remote object holding a list of blocks."""

    blocks_ref: Any  # ObjectRef -> list[Block]
    metas: list[BlockMetadata]

    @property
    def num_rows(self) -> int:
        return sum(m.num_rows for m in self.metas)

    @property
    def size_bytes(self) -> int:
        return sum(m.size_bytes for m in self.metas)


# -- remote task bodies ------------------------------------------------------


def _rechunk(blocks: list[Block], ctx_target_bytes: int, target_rows: int) -> list[Block]:
    """Merge tiny / split huge blocks toward the target size."""
    out: list[Block] = []
    pending: list[Block] = []
    pending_bytes = 0
    for b in blocks:
        acc = BlockAccessor.for_block(b)
        n, sz = acc.num_rows(), acc.size_bytes()
        if n == 0:
            continue
        if sz > ctx_target_bytes or n > target_rows:
            if pending:
                out.append(BlockAccessor.concat(pending))
                pending, pending_bytes = [], 0
            nsplits = max(int(np.ceil(sz / ctx_target_bytes)), int(np.ceil(n / target_rows)))
            per = -(-n // nsplits)
            for s in range(0, n, per):
                out.append(acc.slice(s, min(s + per, n)))
        else:
            pending.append(acc.block)
            pending_bytes += sz
            if pending_bytes >= ctx_target_bytes:
                out.append(BlockAccessor.concat(pending))
                pending, pending_bytes = [], 0
    if pending:
        out.append(BlockAccessor.concat(pending))
    return out


def _finish(blocks: list[Block], target_bytes: int, target_rows: int):
    blocks = _rechunk(blocks, target_bytes, target_rows)
    metas = [BlockAccessor.for_block(b).get_metadata() for b in blocks]
    return blocks, metas


def _run_read_task(read_task, target_bytes: int, target_rows: int):
    return _finish(list(read_task()), target_bytes, target_rows)


def _stream_read_task(read_task, target_bytes: int, target_rows: int):
    """Streaming read body (num_returns="streaming"): yield one
    (blocks_ref, metas) bundle per ~target_bytes of input as the datasource
    produces blocks, so downstream map stages start while the read is still
    running (reference: read tasks as streaming generators feeding the
    executor's block queue). Blocks are put from the worker; only the small
    (ref, metas) tuple rides the stream."""
    import ray_tpu_torch

    yielded = False
    # one bundle per datasource-yielded block (split to target size if the
    # block is huge) — the yield boundary IS the streaming unit, like the
    # reference's dynamic block splitting; downstream consolidation happens
    # in the map stages' own _finish/_rechunk
    for block in read_task():
        blocks, metas = _finish([block], target_bytes, target_rows)
        yield (ray_tpu_torch.put(blocks), metas)
        yielded = True
    if not yielded:  # empty source still emits one (empty) bundle
        blocks, metas = _finish([], target_bytes, target_rows)
        yield (ray_tpu_torch.put(blocks), metas)


def _run_map_task(transform, blocks: list[Block], target_bytes: int, target_rows: int):
    return _finish(list(transform(iter(blocks))), target_bytes, target_rows)


def _slice_rows(all_blocks: list[list[Block]], start: int, end: int):
    """Row-range slice across an ordered list of bundles (repartition/zip)."""
    flat: list[Block] = [b for blocks in all_blocks for b in blocks]
    out: list[Block] = []
    offset = 0
    for b in flat:
        acc = BlockAccessor.for_block(b)
        n = acc.num_rows()
        lo, hi = max(start - offset, 0), min(end - offset, n)
        if lo < hi:
            out.append(acc.slice(lo, hi))
        offset += n
        if offset >= end:
            break
    return BlockAccessor.concat(out)


class MapTransform:
    """Picklable fused transform: Iterator[Block] -> Iterator[Block].

    Built from a MapChain of logical one-to-one ops. Class-based UDFs are
    instantiated once per worker (actor) via ``prepare()``.
    """

    def __init__(self, ops: list[L.AbstractMap]):
        self.ops = ops
        self._instances: Optional[list[Callable]] = None

    def prepare(self):
        if self._instances is None:
            inst = []
            for op in self.ops:
                fn = op.fn
                if isinstance(fn, type):
                    fn = fn(*op.fn_constructor_args, **op.fn_constructor_kwargs)
                inst.append(fn)
            self._instances = inst
        return self

    def __call__(self, blocks: Iterator[Block]) -> Iterator[Block]:
        self.prepare()
        for op, fn in zip(self.ops, self._instances):
            blocks = self._apply_one(op, fn, blocks)
        return blocks

    def _apply_one(self, op, fn, blocks: Iterator[Block]) -> Iterator[Block]:
        if isinstance(op, L.MapBatches):
            return self._apply_batches(op, fn, blocks)
        if isinstance(op, L.Filter):
            return self._apply_rows(blocks, lambda rows: (r for r in rows if fn(r, *op.fn_args, **op.fn_kwargs)))
        if isinstance(op, L.FlatMap):
            return self._apply_rows(
                blocks, lambda rows: (o for r in rows for o in fn(r, *op.fn_args, **op.fn_kwargs))
            )
        if isinstance(op, (L.MapRows, L.Project)):
            return self._apply_rows(blocks, lambda rows: (fn(r, *op.fn_args, **op.fn_kwargs) for r in rows))
        raise TypeError(f"Unknown map op {op}")

    @staticmethod
    def _apply_rows(blocks, gen):
        for b in blocks:
            rows = list(gen(BlockAccessor.for_block(b).iter_rows()))
            yield BlockAccessor.rows_to_block(rows)

    @staticmethod
    def _apply_batches(op: L.MapBatches, fn, blocks):
        def to_format(block):
            acc = BlockAccessor.for_block(block)
            if op.batch_format in ("numpy", None, "default"):
                return acc.to_numpy_batch()
            if op.batch_format == "pandas":
                return acc.to_pandas()
            if op.batch_format == "pyarrow":
                return acc.to_arrow()
            raise ValueError(f"Unknown batch_format {op.batch_format!r}")

        if op.batch_size is None:
            for b in blocks:
                if BlockAccessor.for_block(b).num_rows() == 0:
                    continue
                out = fn(to_format(b), *op.fn_args, **op.fn_kwargs)
                yield from _coerce_batch_out(out)
            return
        # Re-batch across block boundaries to exactly batch_size rows.
        buf: list[Block] = []
        buffered = 0
        for b in blocks:
            acc = BlockAccessor.for_block(b)
            if acc.num_rows() == 0:
                continue
            buf.append(acc.block)
            buffered += acc.num_rows()
            while buffered >= op.batch_size:
                merged = BlockAccessor.concat(buf)
                macc = BlockAccessor.for_block(merged)
                head = macc.slice(0, op.batch_size)
                rest_n = macc.num_rows() - op.batch_size
                buf = [macc.slice(op.batch_size, macc.num_rows())] if rest_n else []
                buffered = rest_n
                out = fn(to_format(head), *op.fn_args, **op.fn_kwargs)
                yield from _coerce_batch_out(out)
        if buffered:
            merged = BlockAccessor.concat(buf)
            out = fn(to_format(merged), *op.fn_args, **op.fn_kwargs)
            yield from _coerce_batch_out(out)


def _coerce_batch_out(out) -> Iterator[Block]:
    import types

    if isinstance(out, types.GeneratorType):
        for o in out:
            yield BlockAccessor.batch_to_block(o)
    else:
        yield BlockAccessor.batch_to_block(out)


class _MapWorker:
    """Actor body for ActorPoolMapOperator (reference:
    ``operators/actor_pool_map_operator.py``)."""

    def __init__(self, transform: MapTransform):
        self.transform = transform.prepare()

    def ready(self) -> bool:
        return True

    def apply(self, blocks: list[Block], target_bytes: int, target_rows: int):
        return _finish(list(self.transform(iter(blocks))), target_bytes, target_rows)


# -- physical operators ------------------------------------------------------


class PhysicalOp:
    def __init__(self, name: str, inputs: list["PhysicalOp"]):
        self.name = name
        self.inputs = inputs
        self.input_queue: collections.deque[RefBundle] = collections.deque()
        self.output_queue: collections.deque[RefBundle] = collections.deque()
        self.inputs_done = False
        self.finished = False
        # in-flight: meta_ref -> (blocks_ref, extra)
        self.pending: dict[Any, tuple] = {}
        # Datasets are ordered: tasks may COMPLETE out of order but bundles
        # are emitted in dispatch order (reference: preserve_order semantics
        # of the streaming executor for sort/repartition correctness).
        self._order: collections.deque = collections.deque()
        self._done_buf: dict[Any, RefBundle] = {}

    def can_dispatch(self, ctx: DataContext) -> bool:
        return bool(self.input_queue) and len(self.pending) < ctx.max_tasks_per_op

    def dispatch(self, ctx: DataContext):
        raise NotImplementedError

    def _track(self, meta_ref, blocks_ref):
        self.pending[meta_ref] = (blocks_ref, None)
        self._order.append(meta_ref)

    def on_task_done(self, meta_ref, ctx: DataContext):
        blocks_ref, _ = self.pending.pop(meta_ref)
        metas = ray_tpu_torch.get(meta_ref)
        self._done_buf[meta_ref] = RefBundle(blocks_ref, metas)
        while self._order and self._order[0] in self._done_buf:
            self.output_queue.append(self._done_buf.pop(self._order.popleft()))

    def maybe_finish(self):
        if self.inputs_done and not self.input_queue and not self.pending:
            self.finished = True

    def poll(self, ctx: DataContext) -> None:
        """Called every loop step: ops with out-of-band progress (streaming
        reads) move it into output_queue here."""

    def shutdown(self):
        pass

    def buffered_output_bytes(self) -> int:
        return sum(b.size_bytes for b in self.output_queue)

    def queued_bytes(self) -> int:
        """Un-consumed bytes parked at this op (input + output queues) —
        the quantity global backpressure must bound."""
        return sum(b.size_bytes for b in self.input_queue) + self.buffered_output_bytes()


class InputOp(PhysicalOp):
    """Feeds pre-existing bundles (InputData / materialized datasets)."""

    def __init__(self, bundles: list[RefBundle]):
        super().__init__("Input", [])
        self.output_queue.extend(bundles)
        self.inputs_done = True
        self.finished = True


class ReadOp(PhysicalOp):
    """Reads stream: each read task runs as a streaming-generator task whose
    items become bundles as the datasource produces blocks — downstream
    stages start on a big file's first blocks while its tail is still being
    read. Bundles still emit in dispatch order (ordered-dataset semantics):
    the front stream flows through immediately; later streams buffer until
    it finishes."""

    def __init__(self, read_tasks: list, remote_opts: dict):
        super().__init__("Read", [])
        self._tasks = collections.deque(read_tasks)
        self.inputs_done = True
        self._remote = ray_tpu_torch.remote(_stream_read_task).options(
            num_returns="streaming", **remote_opts
        )
        import threading

        self._slock = threading.Lock()
        self._streams: collections.deque[dict] = collections.deque()

    def can_dispatch(self, ctx):
        return bool(self._tasks) and len(self._streams) < ctx.max_tasks_per_op

    def dispatch(self, ctx):
        rt = self._tasks.popleft()
        rec = {
            "rt": rt, "buf": collections.deque(), "done": False, "err": None,
            # operator-level fault tolerance: streams are never replayed by
            # the core (a consumer may have seen items of the dead run), so
            # the READ OP re-runs the deterministic read task itself and
            # skips the bundles it already emitted — the data-plane analog
            # of lineage reconstruction (reference: Ray Data retries failed
            # read/map tasks at the operator layer)
            "emitted": 0, "retries": 3, "epoch": 0,
            "ctx_args": (ctx.target_max_block_size, ctx.target_max_rows_per_block),
        }
        with self._slock:
            self._streams.append(rec)
        self._spawn_feed(rec)

    def _spawn_feed(self, rec):
        import threading

        old = rec.get("gen")
        if old is not None:
            try:
                old.close()  # dispose the superseded stream + its producer
            except Exception:
                pass
        gen = self._remote.remote(rec["rt"], *rec["ctx_args"])
        rec["gen"] = gen
        threading.Thread(
            target=self._feed, args=(gen, rec, rec["emitted"], rec["epoch"]),
            name="read-stream-feed", daemon=True,
        ).start()

    def _feed(self, gen, rec, skip: int, epoch: int):
        """All rec mutations are epoch-guarded under _slock: a superseded
        feed thread (its stream was retried) must never mark the fresh
        epoch done/errored or append stale bundles."""
        try:
            for item_ref in gen:
                blocks_ref, metas = ray_tpu_torch.get(item_ref)
                with self._slock:
                    if rec["epoch"] != epoch:
                        return  # retried underneath us: hand over entirely
                    if skip > 0:
                        skip -= 1  # replay of an already-emitted bundle
                        continue
                    rec["buf"].append(RefBundle(blocks_ref, metas))
        except BaseException as e:  # noqa: BLE001 - surfaced in poll()
            with self._slock:
                if rec["epoch"] == epoch:
                    rec["err"] = e
        finally:
            with self._slock:
                if rec["epoch"] == epoch:
                    rec["done"] = True

    @staticmethod
    def _retriable(err) -> bool:
        from ray_tpu_torch import exceptions as rex

        return isinstance(
            err, (rex.WorkerCrashedError, rex.RayActorError, rex.ObjectLostError)
        )

    def poll(self, ctx):
        if self.finished:
            self.shutdown()
            return
        err = None
        respawn = None
        with self._slock:
            while self._streams:
                rec = self._streams[0]
                while rec["buf"]:
                    self.output_queue.append(rec["buf"].popleft())
                    rec["emitted"] += 1
                if rec["err"] is not None:
                    if self._retriable(rec["err"]) and rec["retries"] != 0:
                        if rec["retries"] > 0:
                            rec["retries"] -= 1
                        rec["err"] = None
                        rec["done"] = False
                        rec["buf"].clear()
                        rec["epoch"] += 1  # invalidates the old feed thread
                        respawn = rec
                    else:
                        err = rec["err"]
                    break
                if rec["done"]:
                    self._streams.popleft()
                    continue
                break
        if respawn is not None:
            self._spawn_feed(respawn)  # outside _slock: submits a task
        if err is not None:
            raise err

    def maybe_finish(self):
        if not self._tasks and not self._streams and not self.pending:
            self.finished = True

    def shutdown(self):
        from ray_tpu_torch._private.log_util import warn_throttled

        with self._slock:
            for rec in self._streams:
                try:
                    rec["gen"].close()
                except Exception as e:
                    # the producer may already be dead (its items consumed);
                    # log so a systematically failing dispose isn't silent
                    warn_throttled("data read op: stream dispose", e)
            self._streams.clear()


class TaskMapOp(PhysicalOp):
    def __init__(self, name: str, transform: MapTransform, remote_opts: dict):
        super().__init__(name, [])
        self.transform = transform
        self._remote = ray_tpu_torch.remote(_run_map_task).options(num_returns=2, **remote_opts)

    def dispatch(self, ctx):
        bundle = self.input_queue.popleft()
        blocks_ref, meta_ref = self._remote.remote(
            self.transform, bundle.blocks_ref, ctx.target_max_block_size, ctx.target_max_rows_per_block
        )
        self._track(meta_ref, blocks_ref)


class ActorMapOp(PhysicalOp):
    """Fixed-size actor pool; bundles go to the least-loaded ready actor."""

    def __init__(self, name: str, transform: MapTransform, pool_size: int, remote_opts: dict):
        super().__init__(name, [])
        actor_cls = ray_tpu_torch.remote(_MapWorker).options(**remote_opts)
        self._actors = [actor_cls.remote(transform) for _ in range(pool_size)]
        for a in self._actors:
            a.ready.remote()
        self._load = {i: 0 for i in range(pool_size)}
        self._by_meta: dict[Any, int] = {}

    def can_dispatch(self, ctx):
        return bool(self.input_queue) and any(
            v < ctx.max_tasks_in_flight_per_actor for v in self._load.values()
        )

    def dispatch(self, ctx):
        bundle = self.input_queue.popleft()
        idx = min(self._load, key=self._load.get)
        blocks_ref, meta_ref = self._actors[idx].apply.options(num_returns=2).remote(
            bundle.blocks_ref, ctx.target_max_block_size, ctx.target_max_rows_per_block
        )
        self._track(meta_ref, blocks_ref)
        self._load[idx] += 1
        self._by_meta[meta_ref] = idx

    def on_task_done(self, meta_ref, ctx):
        self._load[self._by_meta.pop(meta_ref)] -= 1
        super().on_task_done(meta_ref, ctx)

    def shutdown(self):
        from ray_tpu_torch._private.log_util import warn_throttled

        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception as e:
                # best-effort teardown (the actor may already be gone), but
                # a kill that ALWAYS fails leaks pool actors — say so
                warn_throttled("data actor-map op: actor kill", e)


class LimitOp(PhysicalOp):
    """Driver-side limit using metadata only; slices the boundary bundle."""

    def __init__(self, limit: int):
        super().__init__(f"Limit({limit})", [])
        self._remaining = limit

    def can_dispatch(self, ctx):
        return bool(self.input_queue)

    def dispatch(self, ctx):
        bundle = self.input_queue.popleft()
        if self._remaining <= 0:
            return
        if bundle.num_rows <= self._remaining:
            self._remaining -= bundle.num_rows
            self.output_queue.append(bundle)
        else:
            take = self._remaining
            self._remaining = 0
            blocks_ref, meta_ref = (
                ray_tpu_torch.remote(_limit_task).options(num_returns=2).remote(bundle.blocks_ref, take)
            )
            self._track(meta_ref, blocks_ref)
        if self._remaining <= 0:
            self.input_queue.clear()
            self.inputs_done = True

    def maybe_finish(self):
        if self.inputs_done and not self.input_queue and not self.pending:
            self.finished = True

    @property
    def satisfied(self) -> bool:
        return self._remaining <= 0


def _limit_task(blocks: list[Block], take: int):
    out = []
    for b in blocks:
        acc = BlockAccessor.for_block(b)
        n = acc.num_rows()
        if take <= 0:
            break
        out.append(acc.slice(0, min(take, n)))
        take -= n
    blocks = out
    return blocks, [BlockAccessor.for_block(b).get_metadata() for b in blocks]


class AllToAllOp(PhysicalOp):
    """Barrier exchange: collects every input bundle, then runs a two-stage
    map/reduce plan (reference: ``planner/exchange`` + shuffle ops)."""

    def __init__(self, kind: str, options: dict):
        super().__init__(kind, [])
        self.kind = kind
        self.options = options
        self._collected: list[RefBundle] = []
        self._launched = False

    def can_dispatch(self, ctx):
        return bool(self.input_queue) or (
            self.inputs_done and not self._launched and not self.pending
        )

    def dispatch(self, ctx):
        while self.input_queue:
            self._collected.append(self.input_queue.popleft())
        if self.inputs_done and not self._launched:
            self._launched = True
            self._launch(ctx)

    def _launch(self, ctx: DataContext):
        from ray_tpu_torch.data import exchange

        bundles, self._collected = self._collected, []
        for blocks_ref, meta_ref in exchange.launch(self.kind, bundles, self.options, ctx):
            self._track(meta_ref, blocks_ref)
        # the exchange's tasks hold their inputs now: dropping the op's own
        # refs lets the store free each input once its map task is done

    def maybe_finish(self):
        if self.inputs_done and self._launched and not self.pending and not self.input_queue:
            self.finished = True


class UnionOp(PhysicalOp):
    """Concatenation preserving dataset order: child i's bundles are emitted
    only after every child < i has finished."""

    def __init__(self, name, inputs):
        super().__init__(name, inputs)
        self.per_child: list[collections.deque] = []

    def can_dispatch(self, ctx):
        return any(self.per_child)

    def dispatch(self, ctx):
        for i, q in enumerate(self.per_child):
            while q:
                self.output_queue.append(q.popleft())
            if not self.inputs[i].finished:
                break

    def maybe_finish(self):
        if self.inputs_done and not any(self.per_child) and not self.pending:
            self.finished = True

    def queued_bytes(self) -> int:
        return super().queued_bytes() + sum(b.size_bytes for q in self.per_child for b in q)


class ZipOp(PhysicalOp):
    """Barrier both sides; zip by row ranges (reference: Zip op)."""

    def __init__(self):
        super().__init__("Zip", [])
        self.left: list[RefBundle] = []
        self.right: list[RefBundle] = []
        self._launched = False

    def can_dispatch(self, ctx):
        return self.inputs_done and not self._launched

    def dispatch(self, ctx):
        self._launched = True
        lrefs = [b.blocks_ref for b in self.left]
        rrefs = [b.blocks_ref for b in self.right]
        n_left = sum(b.num_rows for b in self.left)
        n_right = sum(b.num_rows for b in self.right)
        if n_left != n_right:
            raise ValueError(f"zip(): datasets have different row counts ({n_left} vs {n_right})")
        nparts = max(1, min(len(self.left), ctx.max_shuffle_partitions))
        per = -(-n_left // nparts)
        remote = ray_tpu_torch.remote(_zip_task).options(num_returns=2)
        for i in range(nparts):
            start, end = i * per, min((i + 1) * per, n_left)
            if start >= end:
                break
            blocks_ref, meta_ref = remote.remote(start, end, len(lrefs), *lrefs, *rrefs)
            self._track(meta_ref, blocks_ref)

    def maybe_finish(self):
        if self._launched and not self.pending:
            self.finished = True

    def queued_bytes(self) -> int:
        return super().queued_bytes() + sum(b.size_bytes for b in self.left + self.right)


def _zip_task(start: int, end: int, n_left: int, *all_blocks):
    left = _slice_rows(list(all_blocks[:n_left]), start, end)
    right = _slice_rows(list(all_blocks[n_left:]), start, end)
    cols = dict(left)
    for n, v in right.items():
        # Disambiguate duplicates without clobbering existing left columns
        # (a tensor column keeps its shape: it is the array itself).
        name = n
        suffix = 1
        while name in cols:
            name = f"{n}_{suffix}"
            suffix += 1
        cols[name] = v
    blocks = [cols]
    return blocks, [BlockAccessor.for_block(b).get_metadata() for b in blocks]


# -- executor ----------------------------------------------------------------


def build_physical(plan: L.LogicalPlan, ctx: DataContext) -> list[PhysicalOp]:
    """Lower an (optimized) logical plan to a physical op chain (topological
    order: producers before consumers). Child plans of Union/Zip are lowered
    recursively and wired into the consumer's `inputs`."""
    if ctx.enable_operator_fusion:
        plan = plan.optimized()
    ops: list[PhysicalOp] = []
    prev: Optional[PhysicalOp] = None
    for lop in plan.ops:
        if isinstance(lop, L.Read):
            if lop.parallelism > 0:
                parallelism = lop.parallelism
            elif ctx.read_parallelism > 0:
                parallelism = ctx.read_parallelism
            else:
                parallelism = ctx.min_parallelism
            read_tasks = lop.datasource.get_read_tasks(parallelism)
            cur = ReadOp(read_tasks, {})
        elif isinstance(lop, L.InputData):
            cur = InputOp(lop.bundles)
        elif isinstance(lop, L.MapChain):
            cur = _lower_map(lop.ops, lop.name, ctx)
        elif isinstance(lop, L.AbstractMap):
            cur = _lower_map([lop], lop.name, ctx)
        elif isinstance(lop, L.Limit):
            cur = LimitOp(lop.limit)
        elif isinstance(lop, L.AllToAll):
            cur = AllToAllOp(lop.kind, lop.options)
        elif isinstance(lop, L.Union):
            cur = UnionOp("Union", [])
            for child in lop.others:
                child_ops = build_physical(child, ctx)
                ops.extend(child_ops)
                cur.inputs.append(child_ops[-1])
        elif isinstance(lop, L.Zip):
            cur = ZipOp()
            child_ops = build_physical(lop.other, ctx)
            ops.extend(child_ops)
            cur.inputs.append(child_ops[-1])
        else:
            raise TypeError(f"Cannot lower {lop}")
        if prev is not None:
            cur.inputs.insert(0, prev)
        ops.append(cur)
        prev = cur
    return ops


def _lower_map(lops: list[L.AbstractMap], name: str, ctx: DataContext) -> PhysicalOp:
    transform = MapTransform(lops)
    opts = {}
    head = lops[0]
    if head.num_cpus is not None:
        opts["num_cpus"] = head.num_cpus
    if head.num_gpus is not None:
        opts["num_gpus"] = head.num_gpus
    if any(op.uses_actors() for op in lops):
        conc = head.concurrency or 2
        if isinstance(conc, (tuple, list)):
            conc = conc[-1]
        return ActorMapOp(name, transform, int(conc), opts)
    return TaskMapOp(name, transform, opts)


class StreamingExecutor:
    """Pull-based scheduling loop yielding output bundles as they finish.

    Reference: ``StreamingExecutor.run`` loop ``_scheduling_loop_step``
    (``streaming_executor.py:241``): dispatch on the runnable op with the
    least buffered output (backpressure), then harvest completions via
    ``ray_tpu_torch.wait``.
    """

    def __init__(self, plan: L.LogicalPlan, ctx: Optional[DataContext] = None):
        self.ctx = ctx or DataContext.get_current()
        self.ops = build_physical(plan, self.ctx)
        self.final = self.ops[-1]

    def __iter__(self) -> Iterator[RefBundle]:
        try:
            yield from self._run()
        finally:
            self.shutdown()

    def shutdown(self):
        for op in self.ops:
            op.shutdown()

    def _move_edges(self):
        moved = False
        for op in self.ops:
            if isinstance(op, UnionOp) and not op.per_child:
                op.per_child = [collections.deque() for _ in op.inputs]
            for i, parent in enumerate(op.inputs):
                if isinstance(op, ZipOp):
                    side = op.left if parent is op.inputs[0] else op.right
                    while parent.output_queue:
                        side.append(parent.output_queue.popleft())
                        moved = True
                elif isinstance(op, UnionOp):
                    while parent.output_queue:
                        op.per_child[i].append(parent.output_queue.popleft())
                        moved = True
                else:
                    while parent.output_queue:
                        op.input_queue.append(parent.output_queue.popleft())
                        moved = True
            if op.inputs and all(p.finished for p in op.inputs):
                if not op.inputs_done:
                    moved = True
                op.inputs_done = True
        return moved

    def _upstream(self, op: PhysicalOp) -> list[PhysicalOp]:
        out, stack = [], list(op.inputs)
        while stack:
            cur = stack.pop()
            out.append(cur)
            stack.extend(cur.inputs)
        return out

    def _cancel_satisfied_limits(self):
        """Once a Limit has its rows, stop feeding it: mark every upstream op
        finished and drop its queued/pending work (the reference's executor
        propagates completion upstream of a satisfied limit the same way)."""
        for op in self.ops:
            if isinstance(op, LimitOp) and op.satisfied:
                for up in self._upstream(op):
                    if not up.finished:
                        up.finished = True
                        up.inputs_done = True
                        up.input_queue.clear()
                        up.output_queue.clear()
                        up.pending.clear()
                        up._order.clear()
                        up._done_buf.clear()
                        if isinstance(up, ReadOp):
                            up._tasks.clear()
                        up.shutdown()

    def _run(self) -> Iterator[RefBundle]:
        ctx = self.ctx
        while True:
            self._move_edges()
            self._cancel_satisfied_limits()
            # Dispatch: runnable ops, least-buffered-output first.
            runnable = [op for op in self.ops if not op.finished and op.can_dispatch(ctx)]
            runnable.sort(key=lambda o: o.queued_bytes())
            dispatched = False
            buffered = sum(o.queued_bytes() for o in self.ops)
            for op in runnable:
                if buffered > ctx.max_buffered_bytes and isinstance(op, (ReadOp, InputOp)):
                    continue  # backpressure: stop ingesting, keep draining
                op.dispatch(ctx)
                dispatched = True
            for op in self.ops:
                op.poll(ctx)
            # Harvest completions.
            pending = [(ref, op) for op in self.ops for ref in op.pending]
            if pending:
                refs = [r for r, _ in pending]
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0.02)
                owner = dict(pending)
                for ref in ready:
                    owner[ref].on_task_done(ref, ctx)
            for op in self.ops:
                op.maybe_finish()
            self._move_edges()
            while self.final.output_queue:
                yield self.final.output_queue.popleft()
            if self.final.finished:
                return
            if not dispatched and not pending:
                # Nothing running and nothing to do: either done or stalled.
                if all(op.finished for op in self.ops):
                    return
                time.sleep(0.005)


def execute_to_bundles(plan: L.LogicalPlan, ctx: Optional[DataContext] = None) -> list[RefBundle]:
    return list(StreamingExecutor(plan, ctx))
