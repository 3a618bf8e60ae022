"""DataIterator: batched consumption with prefetch, plus streaming_split
(port of ``ray_tpu/data/iterator.py``).

Reference: ``python/ray/data/iterator.py`` (iter_batches / iter_torch_batches
/ to_tf) and ``_internal/execution/streaming_split`` (SplitCoordinator actor
serving N concurrent consumers). ``iter_torch_batches`` is the counterpart of
the JAX package's ``iter_jax_batches``: numpy batches are prefetched on a
background thread (``prefetch_batches`` in flight) and each is moved to the
device in the consumer, the card unless ``device`` says otherwise. This
module imports no torch: only ``iter_torch_batches`` does, when called.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Any, Callable, Iterator, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor


class DataIterator:
    """Iterates batches from a block-producing source (re-iterable)."""

    def __init__(self, bundle_source: Callable[[], Iterator[Any]]):
        # bundle_source: () -> iterator of blocks_refs (each -> list[Block])
        self._source = bundle_source

    # -- raw ----------------------------------------------------------------

    def _iter_blocks(self, prefetch: int) -> Iterator[Block]:
        """Yield blocks as bundles arrive. The ref stream + object fetch run
        on a background thread with a bounded queue: gets overlap with
        consumer compute, and — unlike a hold-back window — an
        already-available block is NEVER gated on the producer's next bundle
        (matters for streaming reads, where the first block can be ready
        seconds before a slow source finishes)."""

        def produce() -> Iterator[Block]:
            for ref in self._source():
                yield from ray_tpu_torch.get(ref)

        if prefetch > 0:
            yield from _bg_prefetch(produce, prefetch)
        else:
            yield from produce()

    def iter_rows(self) -> Iterator[dict]:
        for block in self._iter_blocks(prefetch=1):
            yield from BlockAccessor.for_block(block).iter_rows()

    # -- batches ------------------------------------------------------------

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
        prefetch_batches: int = 1,
    ) -> Iterator[Any]:
        def produce() -> Iterator[Any]:
            for block in self._batch_blocks(
                batch_size, drop_last, local_shuffle_buffer_size, local_shuffle_seed, prefetch_batches
            ):
                yield _format(block, batch_format)

        if prefetch_batches > 0:
            yield from _bg_prefetch(produce, prefetch_batches)
        else:
            yield from produce()

    def _batch_blocks(
        self,
        batch_size: Optional[int],
        drop_last: bool,
        local_shuffle_buffer_size: Optional[int],
        local_shuffle_seed: Optional[int],
        prefetch_batches: int,
    ) -> Iterator[Block]:
        """The batches of ``iter_batches``, as blocks."""
        if local_shuffle_buffer_size and batch_size is None:
            raise ValueError("local_shuffle_buffer_size requires a batch_size")

        def produce() -> Iterator[Block]:
            buf: list[Block] = []
            buffered = 0
            min_buffer = local_shuffle_buffer_size or 0
            rng = np.random.default_rng(local_shuffle_seed)
            for block in self._iter_blocks(prefetch_batches):
                acc = BlockAccessor.for_block(block)
                if acc.num_rows() == 0:
                    continue
                buf.append(acc.block)
                buffered += acc.num_rows()
                if batch_size is None:
                    if not min_buffer:
                        yield buf.pop()
                        buffered = 0
                    continue
                while buffered >= max(batch_size, min_buffer + batch_size):
                    merged = BlockAccessor.concat(buf)
                    macc = BlockAccessor.for_block(merged)
                    if min_buffer:
                        perm = rng.permutation(macc.num_rows())
                        merged = macc.take_indices(perm)
                        macc = BlockAccessor.for_block(merged)
                    head = macc.slice(0, batch_size)
                    buf = [macc.slice(batch_size, macc.num_rows())]
                    buffered = macc.num_rows() - batch_size
                    yield head
            # Drain.
            if buffered and batch_size is not None:
                merged = BlockAccessor.concat(buf)
                macc = BlockAccessor.for_block(merged)
                if min_buffer:
                    perm = rng.permutation(macc.num_rows())
                    merged = macc.take_indices(perm)
                    macc = BlockAccessor.for_block(merged)
                for s in range(0, macc.num_rows(), batch_size):
                    e = min(s + batch_size, macc.num_rows())
                    if e - s < batch_size and drop_last:
                        return
                    yield macc.slice(s, e)

        return produce()

    def iter_torch_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        dtypes: Optional[dict] = None,
        device: Optional[Any] = None,
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
        prefetch_batches: int = 2,
        sharding: Optional[Any] = None,
    ) -> Iterator[dict]:
        """Batches as dicts of ``torch.Tensor`` on ``device``: the card when
        ``device`` is None (``resolve_device``; without a GPU this raises),
        ``"cpu"`` or any torch device otherwise. ``dtypes`` maps a column to
        a torch dtype, applied on the device. A batch moved to the CPU is a
        copy whenever its arrays are views of the object store, so the
        tensors handed out may be written in place.

        ``sharding`` (a ``parallel.sharding.NamedSharding``, the reference's
        ``jax.sharding.NamedSharding``) places each column on its mesh
        instead: ``dtypes`` applied on the host first, as the reference's
        ``astype``, then a ``DTensor`` of this rank's shard (``global_put``:
        no communication, so every rank must read the same rows; blocks
        come in dispatch order, and a local shuffle over more than one
        process needs a ``local_shuffle_seed``). ``device`` is then the
        mesh's."""
        if sharding is not None:
            from ray_tpu_torch.parallel.sharding import NamedSharding

            if not isinstance(sharding, NamedSharding):
                raise TypeError(f"iter_torch_batches(sharding=...) takes a "
                                f"ray_tpu_torch.parallel.sharding.NamedSharding, got {type(sharding).__name__}")
            if local_shuffle_buffer_size and local_shuffle_seed is None and sharding.mesh.size() > 1:
                raise ValueError(f"a local shuffle feeding a mesh of {sharding.mesh.size()} processes needs a "
                                 "local_shuffle_seed: every rank must read the same rows")
            import torch

            dev = torch.device("cpu")
        else:
            from ray_tpu_torch.device import resolve_device

            dev = resolve_device(device)
        source = self._batch_blocks(
            batch_size, drop_last, local_shuffle_buffer_size, local_shuffle_seed, prefetch_batches
        )
        blocks = _bg_prefetch(lambda: source, prefetch_batches) if prefetch_batches > 0 else source
        batches = _torch_batches(blocks, dtypes or {}, dev)
        if sharding is None:
            return batches
        return ({k: sharding.put(v) for k, v in b.items()} for b in batches)

    def materialize(self):
        """Collect this iterator's shard into a materialized Dataset."""
        from ray_tpu_torch.data.dataset import MaterializedDataset, _bundles_from_blocks

        blocks = list(self._iter_blocks(prefetch=2))
        return MaterializedDataset(_bundles_from_blocks(blocks))


def _torch_batches(blocks: Iterator[Block], dtypes: dict, device) -> Iterator[dict]:
    import torch

    for block in blocks:
        out = {}
        for k, v in block.items():
            if device.type == "cpu" and not _owns_memory(v):
                v = v.copy()  # a view of the object store: never hand it out
            v = np.ascontiguousarray(v)
            if v.flags.writeable:
                t = torch.from_numpy(v)
            else:  # read only, by the copy to the device below
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    t = torch.from_numpy(v)
            if device.type != "cpu":
                t = t.to(device)
            if k in dtypes:
                t = t.to(dtypes[k])
            out[k] = t
        yield out


def _owns_memory(v: np.ndarray) -> bool:
    """Whether ``v``'s memory is a numpy allocation (a view of one counts),
    not a buffer of the object store."""
    while isinstance(v.base, np.ndarray):
        v = v.base
    return v.base is None and v.flags.writeable


def _format(block, batch_format: str):
    acc = BlockAccessor.for_block(block)
    if batch_format in ("numpy", None, "default"):
        return acc.to_numpy_batch()
    if batch_format == "pandas":
        return acc.to_pandas()
    if batch_format == "pyarrow":
        return acc.to_arrow()
    raise ValueError(f"Unknown batch_format {batch_format!r}")


def _bg_prefetch(produce: Callable[[], Iterator], depth: int) -> Iterator:
    """Run the producer on a thread with a bounded queue (overlaps object
    fetch + format conversion with consumer compute). If the consumer
    abandons the iterator early, the stop event unblocks the producer so the
    underlying executor generator is closed (actor pools shut down, refs
    released) instead of leaking a thread parked on a full queue."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    DONE, ERR = object(), object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        gen = produce()
        try:
            for item in gen:
                if not put(item):
                    return
            put(DONE)
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            put((ERR, e))
        finally:
            close = getattr(gen, "close", None)
            if close:
                close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is ERR:
                raise item[1]
            yield item
    finally:
        stop.set()


class SplitCoordinator:
    """Actor distributing one streaming execution across N consumers.

    Reference: ``python/ray/data/_internal/execution/streaming_split``
    (SplitCoordinator). Each epoch re-runs the plan; consumers pull bundles
    round-robin-by-arrival; with ``equal=True`` every consumer sees the same
    number of bundles, and the trailing partial group is re-sliced at row
    granularity so each consumer also sees the same number of rows (only the
    sub-``n`` row remainder is dropped).
    """

    def __init__(self, plan, n: int, equal: bool):
        self._plan = plan
        self._n = n
        self._equal = equal
        self._lock = threading.Lock()
        # Per-epoch queue sets: a lagging consumer keeps draining ITS epoch's
        # queues even after a faster consumer has started the next epoch.
        self._epochs: dict[int, list[queue.Queue]] = {}
        self._finished_counts: dict[int, int] = {}

    def start_epoch(self, epoch: int) -> bool:
        with self._lock:
            if epoch in self._epochs or epoch in self._finished_counts:
                return False
            # Bounded: consumers lagging behind apply backpressure to the
            # executor thread instead of buffering the whole dataset.
            queues = [queue.Queue(maxsize=8) for _ in range(self._n)]
            self._epochs[epoch] = queues
            self._finished_counts[epoch] = 0
            threading.Thread(target=self._pump, args=(queues,), daemon=True).start()
            return True

    def _pump(self, queues):
        from ray_tpu_torch.data.execution import StreamingExecutor

        try:
            i = 0
            pending: list = []
            for bundle in StreamingExecutor(self._plan.copy()):
                if self._equal:
                    pending.append(bundle.blocks_ref)
                    if len(pending) == self._n:
                        for qi, ref in zip(queues, pending):
                            qi.put(ref)
                        pending = []
                else:
                    queues[i % self._n].put(bundle.blocks_ref)
                    i += 1
            if self._equal and pending:
                self._split_remainder_rows(queues, pending)
            for qi in queues:
                qi.put(None)
        except BaseException as e:  # noqa: BLE001
            for qi in queues:
                qi.put(("__err__", repr(e)))

    def _split_remainder_rows(self, queues, pending):
        """equal=True tail: fewer trailing bundles than consumers. The
        reference equalizes at ROW granularity (``streaming_split``
        SplitCoordinator) — slice the leftover bundles' rows evenly across
        all consumers instead of silently dropping them (with coarse
        bundles that tail can be a large fraction of the epoch)."""
        import ray_tpu_torch
        from ray_tpu_torch.data.block import BlockAccessor

        blocks = []
        for ref in pending:
            blocks.extend(ray_tpu_torch.get(ref))
        total = sum(BlockAccessor.for_block(b).num_rows() for b in blocks)
        per = total // self._n
        if per <= 0:
            return  # fewer rows than consumers — nothing equal to hand out
        parts: list[list] = [[] for _ in range(self._n)]
        qi, need = 0, per
        for b in blocks:
            acc = BlockAccessor.for_block(b)
            off, n_rows = 0, acc.num_rows()
            while off < n_rows and qi < self._n:
                take = min(need, n_rows - off)
                parts[qi].append(acc.slice(off, off + take))
                off += take
                need -= take
                if need == 0:
                    qi += 1
                    need = per
        for q, blks in zip(queues, parts):
            if blks:
                q.put(ray_tpu_torch.put(blks))

    def next_bundle(self, split_idx: int, epoch: int):
        """Blocking pull; returns a blocks_ref or None at end of epoch."""
        self.start_epoch(epoch)
        with self._lock:
            queues = self._epochs.get(epoch)
        if queues is None:  # this consumer already saw end-of-epoch
            return None
        item = queues[split_idx].get()
        if isinstance(item, tuple) and item and item[0] == "__err__":
            raise RuntimeError(f"streaming_split execution failed: {item[1]}")
        if item is None:
            with self._lock:
                self._finished_counts[epoch] += 1
                if self._finished_counts[epoch] >= self._n:
                    self._epochs.pop(epoch, None)
        return item


class SplitIterator(DataIterator):
    """One consumer's view of a SplitCoordinator."""

    def __init__(self, coordinator, split_idx: int):
        self._coord = coordinator
        self._idx = split_idx
        self._epoch = 0
        super().__init__(self._pull)

    def _pull(self):
        epoch = self._epoch
        self._epoch += 1
        while True:
            ref = ray_tpu_torch.get(self._coord.next_bundle.remote(self._idx, epoch))
            if ref is None:
                return
            yield ref
