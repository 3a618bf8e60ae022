"""Zero-copy-aware serialization (copy of ``ray_tpu/_private/serialization.py``
with the tensor seam).

Values are serialized with cloudpickle at pickle protocol 5 so large
contiguous buffers (numpy arrays, arrow buffers) travel out-of-band. The
out-of-band buffers are what the shared-memory store lays out contiguously,
giving zero-copy reads on the consumer side (the plasma mmap equivalent).

**Tensors.** A ``torch.Tensor`` pickles its storage in-band, so without help
every tensor would be copied through the pickle stream. Here a reducer
(``reducer_override``, consulted only when ``torch`` is already in
``sys.modules`` — this module imports no torch, and the forkserver template
imports it) hands a tensor's bytes to pickle as one out-of-band buffer,
exactly as numpy arrays travel:

- a CPU tensor's bytes go as a same-width integer view (numpy lacks bf16 and
  the fp8 types) and are reinterpreted on arrival; a same-node ``get`` of a
  large tensor gives a zero-copy view of the shared-memory store;
- dense layouts (contiguous or permuted) keep their strides; other views
  (slices with gaps, expanded dims) travel compacted, values and shape
  exact; 0-dim and empty tensors round-trip; ``requires_grad`` survives as
  on a leaf, as torch's own pickling gives;
- a CUDA tensor goes through host memory and arrives on the receiver's
  current CUDA device, the counterpart of a jax array being ``device_put``
  on its receiver. A receiver without a card raises: the tensor never comes
  back on the CPU quietly.

Tensor subclasses (``nn.Parameter``) keep their own reduction, which hands
the reducer their plain ``.data`` tensor.
"""

from __future__ import annotations

import io
import os
import pickle
import sys
from typing import Any

import cloudpickle


class SerializedValue:
    """A pickled header plus out-of-band buffers.

    total_size == len(header) + sum(buffer sizes); the store uses this to
    decide inline vs shared-memory placement.
    """

    __slots__ = ("header", "buffers", "total_size")

    def __init__(self, header: bytes, buffers: list[pickle.PickleBuffer]):
        self.header = header
        self.buffers = buffers
        self.total_size = len(header) + sum(len(b.raw()) for b in buffers)

    def to_bytes(self) -> bytes:
        """Flatten to a single self-describing byte string (for socket
        transport of small objects)."""
        if not self.buffers:
            # no out-of-band buffers (every small value): one concat, no
            # BytesIO round trip — this runs once per task result
            return (
                len(self.header).to_bytes(8, "little")
                + b"\x00\x00\x00\x00"
                + self.header
            )
        out = io.BytesIO()
        out.write(len(self.header).to_bytes(8, "little"))
        out.write(len(self.buffers).to_bytes(4, "little"))
        for b in self.buffers:
            out.write(len(b.raw()).to_bytes(8, "little"))
        out.write(self.header)
        for b in self.buffers:
            out.write(b.raw())
        return out.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes | memoryview) -> "SerializedValue":
        mv = memoryview(data)
        if len(mv) < 12:
            raise ValueError("truncated serialized value")
        hlen = int.from_bytes(mv[:8], "little")
        nbuf = int.from_bytes(mv[8:12], "little")
        off = 12
        if nbuf > (len(mv) - off) // 8:
            raise ValueError("corrupt serialized value (buffer count)")
        sizes = []
        for _ in range(nbuf):
            sizes.append(int.from_bytes(mv[off : off + 8], "little"))
            off += 8
        if off + hlen + sum(sizes) != len(mv):
            # length mismatch = truncated/corrupt payload (spill-file rot is
            # the practical case; callers fall back to lineage/LOST)
            raise ValueError("corrupt serialized value (length mismatch)")
        header = bytes(mv[off : off + hlen])
        off += hlen
        bufs = []
        for s in sizes:
            bufs.append(pickle.PickleBuffer(mv[off : off + s]))
            off += s
        return cls(header, bufs)


#: integer dtype (by name) of each element width a tensor's bytes travel as
_WIRE_DTYPES = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def _reduce_tensor(obj):
    """``reducer_override`` body: the out-of-band reduction of a plain
    ``torch.Tensor`` (see the module doc), or NotImplemented for anything
    else, which pickles as it always does."""
    torch = sys.modules.get("torch")
    if torch is None or type(obj) is not torch.Tensor:
        return NotImplemented
    if (
        obj.layout is not torch.strided
        or obj.is_quantized
        or obj.device.type not in ("cpu", "cuda")
    ):
        return NotImplemented  # torch's own reduction (in-band)
    device = obj.device.type
    t = obj.detach()
    if device == "cuda":
        t = t.cpu()  # through host memory; synchronises with the stream
    t = t.resolve_conj().resolve_neg()
    shape = tuple(t.shape)
    numel = t.numel()
    if numel == 0:
        return _rebuild_tensor, (
            None, str(t.dtype)[len("torch."):], shape, tuple(t.stride()),
            obj.requires_grad, device,
        )
    extent = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    if extent != numel:  # gaps or overlap: ship the values compacted
        t = t.contiguous()
    # the dense span of memory the tensor covers, as one flat run
    flat = t.as_strided((numel,), (1,), t.storage_offset())
    flat = flat.view(getattr(torch, _WIRE_DTYPES.get(t.element_size(), "uint8")))
    return _rebuild_tensor, (
        pickle.PickleBuffer(flat.numpy()), str(t.dtype)[len("torch."):], shape,
        tuple(t.stride()), obj.requires_grad, device,
    )


def _rebuild_tensor(buf, dtype_name, shape, stride, requires_grad, device):
    """Inverse of ``_reduce_tensor``: a view of ``buf`` (zero copy when it is
    a writable out-of-band buffer, e.g. the shared-memory store's mapping),
    moved to this process's current CUDA device when it left one."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA tensor arrived in a process with no CUDA device "
            "(torch.cuda.is_available() is False); it is not moved to the "
            "CPU in its place: run the receiver with a GPU (num_gpus=1) or "
            "send t.cpu()"
        )
    dtype = getattr(torch, dtype_name)
    if buf is None:
        t = torch.empty_strided(shape, stride, dtype=dtype)
    else:
        if memoryview(buf).readonly:
            buf = bytearray(buf)  # inline bytes off the socket: own a copy
        wire = getattr(torch, _WIRE_DTYPES.get(dtype.itemsize, "uint8"))
        flat = torch.frombuffer(buf, dtype=wire).view(dtype)
        t = flat.as_strided(shape, stride)
    if device == "cuda":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    if requires_grad:
        t.requires_grad_(True)
    return t


class _TensorPickler(pickle.Pickler):
    """The C pickler with the tensor reduction (used once torch is loaded)."""

    def reducer_override(self, obj):
        return _reduce_tensor(obj)


class _TensorCloudPickler(cloudpickle.Pickler):
    """cloudpickle (by-value functions and classes) with the tensor
    reduction."""

    def reducer_override(self, obj):
        out = _reduce_tensor(obj)
        if out is NotImplemented:
            return super().reducer_override(obj)
        return out


def _dumps(pickler_cls, value: Any, buffer_callback) -> bytes:
    with io.BytesIO() as f:
        pickler_cls(f, protocol=5, buffer_callback=buffer_callback).dump(value)
        return f.getvalue()


def serialize(value: Any) -> SerializedValue:
    buffers: list[pickle.PickleBuffer] = []

    def cb(buf: pickle.PickleBuffer):
        # Only keep genuinely large buffers out-of-band; tiny ones are cheaper
        # inline in the header.
        if buf.raw().nbytes >= 4096:
            buffers.append(buf)
            return False  # out-of-band
        return True  # serialize in-band

    try:
        # C pickler first: ~10x cheaper per call — this runs once per task
        # result and once per by-value argument. Out-of-band buffer
        # extraction works identically. Lambdas/closures raise here and
        # fall back; the DANGEROUS case is silent success: pickle encodes
        # driver-__main__ classes/functions BY REFERENCE, which a worker
        # (different __main__) cannot resolve — cloudpickle pickles them
        # by value. Any __main__ marker in the payload routes to the
        # fallback (a false hit from a user string merely costs the old
        # cloudpickle price).
        if "torch" in sys.modules:
            # the same C pickler with the tensor reduction (a Python call
            # per non-atomic object, so processes without torch keep the
            # plain fast path)
            header = _dumps(_TensorPickler, value, cb)
        else:
            header = pickle.dumps(value, protocol=5, buffer_callback=cb)
        if b"__main__" in header or b"__mp_main__" in header:
            raise ValueError("__main__ reference: reserialize by value")
    except Exception:
        del buffers[:]  # a partial out-of-band list must not leak through
        if "torch" in sys.modules:
            header = _dumps(_TensorCloudPickler, value, cb)
        else:
            header = cloudpickle.dumps(value, protocol=5, buffer_callback=cb)
    return SerializedValue(header, buffers)


def deserialize(header: bytes | memoryview, buffers: list) -> Any:
    return pickle.loads(header, buffers=buffers)


def deserialize_value(sv: SerializedValue) -> Any:
    return pickle.loads(sv.header, buffers=sv.buffers)


def dumps(value: Any) -> bytes:
    """Convenience: fully in-band cloudpickle (control-plane metadata)."""
    return cloudpickle.dumps(value)


def loads(data: bytes) -> Any:
    return pickle.loads(data)


def dumps_with_tensors(value: Any) -> bytes:
    """Fully in-band cloudpickle with the tensor reduction: bytes a file can
    hold (workflow checkpoints), read back by ``pickle.loads``, whose tensors
    arrive as the object plane's do (module doc)."""
    return _dumps(_TensorCloudPickler, value, None)


def conn_send(conn, msg) -> None:
    """Control-plane message send: one-shot C ``pickle.dumps`` straight
    into the connection. ``Connection.send`` builds a ForkingPickler plus
    a BytesIO per message — ~10us of pure overhead that is real money on
    the task plane's per-message hot paths. Control messages carry plain
    data (dicts/bytes/exceptions), never the fd-passing types the mp
    reducers exist for, and the peer's ``recv`` unpickles identically."""
    try:
        conn._send_bytes(pickle.dumps(msg, protocol=5))
    except AttributeError:  # exotic conn without the CPython internals
        conn.send(msg)
    except TypeError as e:
        # a concurrent close nulls the Connection's _handle mid-send and
        # os.write(None, ...) raises TypeError; surface the same family
        # Connection.send's _check_closed raised (OSError) so every
        # existing send guard — worker-death reap, reply guards, the IO
        # loop — keeps classifying it as a dead conn instead of dying
        raise OSError(f"connection closed during send: {e}") from e


#: the flattened serialization of ``None`` — deterministic, so producers
#: ship the constant without re-pickling and consumers recognize it with
#: one bytes compare (the single most common task result: every
#: mutator/noop returns None)
NONE_BYTES = serialize(None).to_bytes()


_NO_MSG = object()

#: sentinel for split_spec_body's identity elision (header values may be None)
_MISSING = object()


def spec_header_id(*parts) -> bytes:
    """Stable 8-byte spec-header id from content parts (bytes pass
    through, everything else hashes by ``repr`` — so ``"streaming"`` and
    ``1`` are both valid ``num_returns`` inputs). Content-derived on
    purpose: every process that rebuilds the same header (deserialized
    actor handles, re-pickled remote functions) mints the SAME id, so
    receiver-side header caches dedupe instead of growing per copy.
    The ONE id rule for both minting sites (ActorHandle._submit_method,
    RemoteFunction._remote) — keep them in lockstep."""
    import hashlib

    h = hashlib.sha1()
    for p in parts:
        h.update(p if isinstance(p, bytes) else repr(p).encode())
        h.update(b"\x00")
    return h.digest()[:8]


def split_spec_body(spec: dict, fields: dict) -> dict:
    """Header-split elision, the ONE implementation both the
    submitter (`runtime._split_for_wire`) and the head (`Head._wire_spec`)
    use — the wire protocol desynchronizes if the rule ever forks. Keep
    only the keys whose values are NOT the very objects the header already
    carries: templates share static fields by reference end to end, so
    identity comparison elides them, and anything rebound per call (a
    resolved ``max_retries``, a ``_pg_bundle``) rides the body."""
    return {
        k: v
        for k, v in spec.items()
        if k != "_hdr" and fields.get(k, _MISSING) is not v
    }


class ConnReader:
    """Buffered framed reader over a ``multiprocessing.Connection`` fd.

    ``Connection.recv`` costs two ``os.read`` syscalls per message (4-byte
    length header, then the body) plus a BytesIO round trip — real money
    at one completion per task. This reader pulls whatever the kernel has
    in ONE read and parses out every complete frame, so a burst of
    coalesced replies costs one syscall, not two per message. Framing
    matches ``Connection._send_bytes``: ``!i`` length prefix, with the
    ``-1 + !Q`` escape for >2GB bodies. The wrapped conn must have no
    other reader once this is attached (send side is unaffected)."""

    __slots__ = ("conn", "fd", "buf")

    def __init__(self, conn):
        self.conn = conn
        self.fd = conn.fileno()
        self.buf = bytearray()

    def _pop(self):
        buf = self.buf
        n = len(buf)
        if n < 4:
            return _NO_MSG
        size = int.from_bytes(buf[:4], "big", signed=True)
        off = 4
        if size == -1:
            if n < 12:
                return _NO_MSG
            size = int.from_bytes(buf[4:12], "big")
            off = 12
        end = off + size
        if n < end:
            return _NO_MSG
        msg = pickle.loads(memoryview(buf)[off:end])
        del buf[:end]
        return msg

    def recv(self):
        """Blocking single-message recv (worker recv loop)."""
        while True:
            msg = self._pop()
            if msg is not _NO_MSG:
                return msg
            data = os.read(self.fd, 65536)
            if not data:
                raise EOFError
            self.buf += data

    def read_available(self) -> list:
        """One kernel read, every complete frame parsed (head IO drain —
        call only when select reported the fd readable). Raises EOFError
        on a closed peer."""
        try:
            data = os.read(self.fd, 262144)
        except BlockingIOError:
            data = None
        if data is not None:
            if not data:
                raise EOFError
            self.buf += data
        out = []
        while True:
            msg = self._pop()
            if msg is _NO_MSG:
                return out
            out.append(msg)
