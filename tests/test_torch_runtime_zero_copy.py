"""The port's runtime against the reference's tests: a mirror of
``tests/test_zero_copy_plane.py`` run on ``ray_tpu_torch``, with no wall-clock bar
and without the tests of modules still to port.

Zero-copy shm object plane + locality-aware scheduling.

Producers above ``core_shm_inline_threshold`` write straight into shared
memory and ship only the locator over the control socket; same-host
consumers map the bytes back out (pin-refcounted), and the scheduler moves
tasks to the node already holding their argument bytes. Reference: the
plasma object store + locality-aware leasing (Ray §4,
``scheduling/policy/hybrid_scheduling_policy.cc`` locality term).
"""

import gc
import os
import pickle
import signal
import tempfile
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import exceptions as rex
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private import shm_store
from ray_tpu_torch._private.config import GLOBAL_CONFIG, resolve_authkey
from ray_tpu_torch._private.head import Head
from ray_tpu_torch._private.node_agent import NodeAgent
from ray_tpu_torch._private.runtime import get_ctx

THRESH = GLOBAL_CONFIG.core_shm_inline_threshold

#: sizes straddling every storage-band boundary: inline, the shm threshold
#: edge, mid-band (the (threshold, 100KB] band that used to ride the socket
#: twice), the old 100KB cutoff edge, and a large arena object
BOUNDARY_SIZES = (
    100,
    THRESH - 64,
    THRESH + 64,
    64 * 1024,
    100 * 1024 + 64,
    1024 * 1024,
)


# The port's counterparts of the reference's conftest fixtures (a fresh
# single-node cluster per test: these tests read per-cluster ledgers).
@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(num_cpus=4, num_tpus=0)
    yield
    ray_tpu_torch.shutdown()


def _blob(n: int) -> bytes:
    # non-constant content so a layout/offset bug can't hide behind
    # compressible or repeated bytes
    return bytes(bytearray((i * 31 + n) % 251 for i in range(n)))


# ---------------------------------------------------------------------------
# get() == put() identity across the size boundaries, per context kind
# ---------------------------------------------------------------------------


def test_identity_boundaries_driver(ray_start_regular):
    head = get_ctx().head
    for n in BOUNDARY_SIZES:
        data = _blob(n)
        ref = ray_tpu_torch.put(data)
        ent = head.objects[ref.binary()]
        if n > THRESH and head.arena_name is not None:
            assert ent.shm is not None, f"{n}B put should be shm-backed"
        else:
            assert ent.small is not None, f"{n}B put should stay inline"
        assert ray_tpu_torch.get(ref, timeout=30) == data


def test_identity_boundaries_worker(ray_start_regular):
    sizes = list(BOUNDARY_SIZES)

    @ray_tpu_torch.remote
    def round_trip(n):
        # worker-context put + get: the worker mints the locator itself
        data = bytes(bytearray((i * 31 + n) % 251 for i in range(n)))
        ref = ray_tpu_torch.put(data)
        return ray_tpu_torch.get(ref, timeout=30) == data

    assert all(ray_tpu_torch.get([round_trip.remote(n) for n in sizes], timeout=120))

    @ray_tpu_torch.remote
    def produce(n):
        return bytes(bytearray((i * 31 + n) % 251 for i in range(n)))

    # worker-produced results resolve identically from the driver
    outs = ray_tpu_torch.get([produce.remote(n) for n in sizes], timeout=120)
    assert outs == [_blob(n) for n in sizes]


def test_identity_boundaries_ray_client():
    """ray:// context: remote driver without arena access ships inline and
    the head re-lays — identity must hold across the same boundaries."""
    key = os.urandom(16).hex()
    os.environ["RAY_TPU_AUTHKEY"] = key
    session = tempfile.mkdtemp(prefix="ray_tpu_zcp_")
    head = Head(os.path.join(session, "head.sock"), authkey=resolve_authkey())
    head.start()
    host, port = head.listen_tcp("127.0.0.1", 0)
    head.add_node({"CPU": 2.0})
    try:
        ray_tpu_torch.init(address=f"ray://{host}:{port}")
        for n in BOUNDARY_SIZES:
            data = _blob(n)
            assert ray_tpu_torch.get(ray_tpu_torch.put(data), timeout=30) == data
    finally:
        os.environ.pop("RAY_TPU_AUTHKEY", None)
        try:
            ray_tpu_torch.shutdown()
        except Exception:
            pass
        head.shutdown()


def test_identity_across_spill_boundary():
    """Objects pushed over the spill watermark restore to their put() value."""
    old = GLOBAL_CONFIG.object_spilling_threshold_bytes
    ray_tpu_torch.init(
        num_cpus=2,
        _system_config={"object_spilling_threshold_bytes": 4 * 1024 * 1024},
    )
    try:
        blobs = [_blob(1024 * 1024 + i) for i in range(8)]
        refs = [ray_tpu_torch.put(b) for b in blobs]
        for ref, b in zip(refs, blobs):
            assert ray_tpu_torch.get(ref, timeout=60) == b
    finally:
        ray_tpu_torch.shutdown()
        # _system_config writes the process-global config: a 4 MB spill
        # watermark left behind would spill the next tests' arena objects
        GLOBAL_CONFIG.object_spilling_threshold_bytes = old


# ---------------------------------------------------------------------------
# pin refcounting: two consumers over one locator, freed under them
# ---------------------------------------------------------------------------


def test_two_consumers_pin_one_locator(ray_start_regular):
    head = get_ctx().head
    if head.arena_name is None:
        pytest.skip("native arena unavailable")
    arena = shm_store.attach_arena(head.arena_name)
    base = arena.n_objects

    arr = np.arange(32 * 1024, dtype=np.int64)  # 256KB, arena-resident
    ref = ray_tpu_torch.put(arr)
    ref_id = ref.binary()
    loc = head.objects[ref_id].shm
    assert loc is not None and loc.offset is not None

    # two independent consumers attach the same block; each read pins it
    r1, r2 = shm_store.ShmReader(loc), shm_store.ShmReader(loc)
    v1, v2 = r1.read(), r2.read()
    assert (v1 == arr).all() and (v2 == arr).all()

    # free the only ref while both consumers hold live views: the arena
    # free must defer to the last unpin, never unmap under a reader
    del ref
    gc.collect()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        with head.lock:
            if ref_id not in head.objects:
                break
        time.sleep(0.05)
    assert (v1 == arr).all() and (v2 == arr).all()  # reads survive the free

    # dropping one consumer keeps the block alive for the other
    del v1, r1
    gc.collect()
    assert (v2 == arr).all()

    # last consumer gone -> the deferred free lands, no arena bytes leak
    del v2, r2
    gc.collect()
    deadline = time.monotonic() + 20
    while arena.n_objects != base and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.05)
    assert arena.n_objects == base


# ---------------------------------------------------------------------------
# byte accounting: same-node get ships locators, never payload bytes
# ---------------------------------------------------------------------------


def test_same_node_get_zero_payload_copies(ray_start_regular, monkeypatch):
    """The 64KB band rides the control socket as LOCATORS in both
    directions: every head->worker message and every worker->head
    completion payload stays far below the object size (byte accounting,
    not vibes), and the head serves zero inline bytes."""
    head = get_ctx().head
    if head.arena_name is None:
        pytest.skip("native arena unavailable")
    N = 64 * 1024

    sent_sizes = []  # every head-side socket write (run_task, resp, ...)
    real_send = ser.conn_send

    def spy_send(conn, msg):
        sent_sizes.append(len(pickle.dumps(msg)))
        return real_send(conn, msg)

    monkeypatch.setattr(ser, "conn_send", spy_send)

    done_sizes = []  # worker->head completion payloads (just deserialized
    real_done = head._on_task_done  # off the socket: same bytes that crossed)
    real_batch = head._on_task_done_batch

    def spy_done(wh, payload):
        done_sizes.append(len(pickle.dumps(payload)))
        return real_done(wh, payload)

    def spy_batch(wh, payloads):
        done_sizes.extend(len(pickle.dumps(p)) for p in payloads)
        return real_batch(wh, payloads)

    head._on_task_done = spy_done
    head._on_task_done_batch = spy_batch

    @ray_tpu_torch.remote
    def produce():
        return bytes(N)

    @ray_tpu_torch.remote
    def consume(b):
        return len(b)

    base_inline = head.inline_bytes_served
    ref = produce.remote()
    assert ray_tpu_torch.get(ref, timeout=60) == bytes(N)  # driver-side read
    assert ray_tpu_torch.get(consume.remote(ref), timeout=60) == N  # worker read

    assert done_sizes, "no completion payloads observed"
    assert max(done_sizes) < N // 4, (
        f"a completion payload carried object bytes: {max(done_sizes)}B"
    )
    big_sends = [s for s in sent_sizes if s >= N]
    assert not big_sends, f"payload-sized socket writes: {big_sends}"
    assert head.inline_bytes_served == base_inline


# ---------------------------------------------------------------------------
# locality-aware scheduling
# ---------------------------------------------------------------------------


def test_tasks_follow_their_data(ray_start_regular):
    head = get_ctx().head
    data_node = head.add_node({"CPU": 2.0, "prod": 4.0})

    @ray_tpu_torch.remote(resources={"prod": 1.0})
    def produce():
        return bytes(256 * 1024)

    @ray_tpu_torch.remote(num_cpus=1)
    def where(b):
        return ray_tpu_torch.get_runtime_context().get_node_id()

    ref = produce.remote()
    ray_tpu_torch.wait([ref], timeout=60)
    with head.lock:
        assert head.objects[ref.binary()].shm.node == data_node.binary()

    # unconstrained single-arg consumers follow the bytes (>=90% is the
    # acceptance bar; sequential placement with capacity free should hit it)
    placements = [ray_tpu_torch.get(where.remote(ref), timeout=60) for _ in range(12)]
    hits = sum(1 for p in placements if p == data_node.hex())
    assert hits >= int(0.9 * len(placements)), placements
    assert head._loc_total >= 12 and head._loc_hits >= hits


def test_locality_yields_when_data_node_full(ray_start_regular):
    """A byte-holding node with no capacity must not wedge placement: the
    task falls through to the hybrid policy and runs elsewhere."""
    head = get_ctx().head
    tiny = head.add_node({"CPU": 1.0, "prod": 1.0})

    @ray_tpu_torch.remote(resources={"prod": 1.0}, num_cpus=0)
    def produce():
        return bytes(64 * 1024)

    @ray_tpu_torch.remote(resources={"prod": 1.0}, num_cpus=1)
    def camp(sec):
        time.sleep(sec)
        return True

    @ray_tpu_torch.remote(num_cpus=1)
    def consume(b):
        return len(b)

    ref = produce.remote()
    ray_tpu_torch.wait([ref], timeout=60)
    camper = camp.remote(3.0)  # occupies tiny's only CPU
    time.sleep(0.3)
    # must not wait out the camper: the fallback node serves it promptly
    assert ray_tpu_torch.get(consume.remote(ref), timeout=60) == 64 * 1024
    assert ray_tpu_torch.get(camper, timeout=60)


def test_no_arg_tasks_unaffected(ray_start_regular):
    """The no-arg hot path stays locality-free (tasks_async regression
    guard): placements without ref args never touch the locality counters."""
    head = get_ctx().head

    @ray_tpu_torch.remote
    def f():
        return 1

    base = head._loc_total
    assert sum(ray_tpu_torch.get([f.remote() for _ in range(64)], timeout=60)) == 64
    assert head._loc_total == base


# ---------------------------------------------------------------------------
# chaos: producer death / owning-node death
# ---------------------------------------------------------------------------


@pytest.fixture
def p2p_cluster(monkeypatch):
    monkeypatch.setenv("RAY_TPU_FORCE_DATA_PLANE", "1")
    authkey = resolve_authkey()
    session = tempfile.mkdtemp(prefix="ray_tpu_zcp_chaos_")
    head = Head(os.path.join(session, "head.sock"), authkey=authkey)
    head.start()
    host, port = head.listen_tcp("127.0.0.1", 0)
    head.add_node({"CPU": 0.0})
    addr = f"{host}:{port}"
    a = NodeAgent(addr, authkey, resources={"CPU": 2.0, "nodeA": 10.0}).start()
    yield {"head": head, "a": a, "address": addr}
    try:
        ray_tpu_torch.shutdown()
    except Exception:
        pass
    a.shutdown()
    head.shutdown()


def test_sigkill_producer_then_node_death_reaps_locators(p2p_cluster):
    """SIGKILL the worker that wrote live arena blocks: the blocks belong
    to the node's arena, not the worker, so readers keep working. Then
    kill the owning NODE: readers of the now-lost (lineage-free) object
    get a retriable ObjectLostError, the directory reaps the node's
    locators, and no arena bytes leak into the head-side ledger."""
    ray_tpu_torch.init(address=p2p_cluster["address"])
    head = p2p_cluster["head"]
    agent = p2p_cluster["a"]

    @ray_tpu_torch.remote(resources={"nodeA": 1.0})
    def produce():
        # ray.put from the worker: a lineage-FREE arena object owned by
        # nodeA, outliving this worker process
        ref = ray_tpu_torch.put(np.full(64 * 1024, 9, dtype=np.int64))
        return os.getpid(), ref

    pid, ref = ray_tpu_torch.get(produce.remote(), timeout=60)
    with head.lock:
        loc = head.objects[ref.binary()].shm
    assert loc is not None and loc.node == agent.node_id_bin

    os.kill(pid, signal.SIGKILL)  # the producer dies; its blocks must not
    time.sleep(0.5)  # (give the head time to notice the death)
    out = ray_tpu_torch.get(ref, timeout=60)  # bytes survive in the node arena
    assert (out[::1024] == 9).all()

    base_head_bytes = head.shm_owner.bytes_used
    from ray_tpu_torch._private.ids import NodeID

    head.remove_node(NodeID(agent.node_id_bin))
    with pytest.raises(rex.ObjectLostError):
        ray_tpu_torch.get(ref, timeout=30)
    with head.lock:
        leaked = [
            oid.hex()
            for oid, e in head.objects.items()
            if e.shm is not None and e.shm.node == agent.node_id_bin
        ]
    assert not leaked, f"directory kept dead-node locators: {leaked}"
    # audit invariant: nothing from the dead node ever entered (or stayed
    # in) the head's own shm ledger
    assert head.shm_owner.bytes_used == base_head_bytes


# ---------------------------------------------------------------------------
# get_inline fallback honors the caller's timeout budget
# ---------------------------------------------------------------------------


def test_get_inline_fallback_honors_timeout_budget(ray_start_regular, monkeypatch):
    """When the data plane errors out, the head-mediated fallback must ask
    with the caller's REMAINING budget — the old timeout=0 poll declared
    loss on locators the head was still re-laying."""
    from ray_tpu_torch._private import data_plane

    ctx = get_ctx()
    loc = shm_store.ShmLocation(
        "/nope", 8, [], 8, offset=None, node=b"\x01" * 16
    )

    monkeypatch.setattr(ctx, "_data_address_for", lambda node: ("127.0.0.1", 1))

    def boom(addr, key, payload):
        raise OSError("owner unreachable")

    monkeypatch.setattr(data_plane, "fetch", boom)

    seen = {}
    expect = ser.serialize("recovered").to_bytes()

    def fake_call(method, **kw):
        assert method == "get_inline"
        seen["timeout"] = kw.get("timeout")
        return [("inline", expect, False)]

    monkeypatch.setattr(ctx, "call", fake_call)

    deadline = time.monotonic() + 7.5
    ok, value = ctx._fetch_via_data_plane(b"o" * 16, loc, deadline)
    assert ok and value == "recovered"
    assert seen["timeout"] is not None and 6.0 < seen["timeout"] <= 7.5

    # no deadline (get(timeout=None)): the fallback may block like get does
    ok, _ = ctx._fetch_via_data_plane(b"o" * 16, loc, None)
    assert ok and seen["timeout"] is None


# ---------------------------------------------------------------------------
# waterfall contract: locator-bearing replies keep all 7 legs
# ---------------------------------------------------------------------------


def test_waterfall_complete_for_locator_replies(ray_start_regular):
    from ray_tpu_torch.util import tracing
    from ray_tpu_torch.util import waterfall as wfl

    wfl.clear()

    @ray_tpu_torch.remote
    def big(i):
        return bytes(64 * 1024)  # shm-threshold band: reply is a locator

    before = get_ctx().call("waterfall")["folded"]
    with tracing.trace_context() as rid:
        outs = ray_tpu_torch.get([big.remote(i) for i in range(8)], timeout=120)
    assert all(len(o) == 64 * 1024 for o in outs)
    s = get_ctx().call("waterfall", recent=32)
    assert s["folded"] - before == 8
    assert s["incomplete"] == 0
    ours = [rec for rec in s["recent"] if rec.get("request_id") == rid]
    assert len(ours) == 8
    for rec in ours:
        stamps = rec["stamps"]
        assert len(stamps) == len(wfl.PHASES)  # reply_recv at head receipt
        assert stamps == sorted(stamps)
        assert all(v >= 0 for v in rec["legs"].values())


# ---------------------------------------------------------------------------
# pipelined (fire-and-forget) worker puts
# ---------------------------------------------------------------------------


def test_pipelined_put_failure_lands_on_the_ref(ray_start_regular):
    """``rpc_put`` never raises: a store failure is recorded ON the object
    id as an error locator, so a fire-and-forget putter's later ``get``
    raises instead of parking forever in the not-yet-arrived wait."""
    from ray_tpu_torch._private.runtime import ObjectID

    head = get_ctx().head
    orig = head._normalize_locator

    def boom(loc):
        raise RuntimeError("store exploded")

    head._normalize_locator = boom
    try:
        oid = ObjectID.for_put().binary()
        # True: the delivery was APPLIED (as an error-store) — only ignored
        # replay duplicates return False
        assert head.rpc_put(oid, small=b"\x01", shm=None, take_ref=True) is True
    finally:
        head._normalize_locator = orig
    loc = head.get_locators([oid], 1.0)[0]
    assert loc[0] == "inline" and loc[2] is True
    err = ser.deserialize_value(ser.SerializedValue.from_bytes(loc[1]))
    assert isinstance(err, RuntimeError)


def test_pipelined_put_replay_is_idempotent(ray_start_regular):
    """A reconnecting client replays puts from un-acked windows — the head
    may have processed the original (only the ack was lost). Replay-flagged
    redelivery of an already-stored put must be ignored: no re-store, no
    take_ref double-count."""
    from ray_tpu_torch._private.runtime import ObjectID

    head = get_ctx().head
    oid = ObjectID.for_put().binary()
    assert head.rpc_put(oid, small=b"\x05", shm=None, take_ref=True) is True
    with head.lock:
        rc0 = head.objects[oid].refcount
    # redelivery: dup detected, side effects NOT applied again
    assert head.rpc_put(oid, small=b"\x05", shm=None, take_ref=True, replay=True) is False
    with head.lock:
        assert head.objects[oid].refcount == rc0
    # a replay whose original never landed stores normally
    oid2 = ObjectID.for_put().binary()
    assert head.rpc_put(oid2, small=b"\x07", shm=None, take_ref=True, replay=True) is True
    loc = head.get_locators([oid2], 1.0)[0]
    assert loc[0] == "inline" and loc[1] == b"\x07"


def test_pipelined_put_then_immediate_use_as_arg(ray_start_regular):
    """A worker's fire-and-forget put followed by a nested submit that
    consumes the ref resolves in order: the head reads each connection's
    messages sequentially, so the put always lands before the submit."""

    @ray_tpu_torch.remote
    def double(x):
        return x * 2

    @ray_tpu_torch.remote
    def chain():
        ref = ray_tpu_torch.put(np.arange(32 * 1024, dtype=np.int32))  # shm band
        return int(ray_tpu_torch.get(double.remote(ref), timeout=30).sum())

    expect = int((np.arange(32 * 1024, dtype=np.int64) * 2).sum())
    assert ray_tpu_torch.get(chain.remote(), timeout=60) == expect


# ---------------------------------------------------------------------------
# object-plane flight deck: poison forensics, ledger, leak audit
# ---------------------------------------------------------------------------


def test_giveup_swept_put_leaves_poison_forensics(p2p_cluster):
    """A pipelined put caught in the give-up sweep (reconnect failed /
    context closing) must leave a forensic trail: a ``core.object.poison``
    event on this process's flight-recorder ring, a retriable error on
    the ref's get, and a ``_poisoned`` entry that lives exactly as long
    as the ref — dropping the last handle drops the entry."""
    from ray_tpu_torch._private import events
    from ray_tpu_torch._private.runtime import ObjectID, ObjectRef

    ray_tpu_torch.init(address=p2p_cluster["address"])
    ctx = get_ctx()
    oid = ObjectID.for_put().binary()
    # a buffered fire-and-forget put that never reached any connection
    with ctx._submit_cv:
        ctx._submit_buf.append(("put", {
            "obj_id": oid, "small": b"\x01", "shm": None, "is_error": False,
            "take_ref": True, "return_ids": [oid],
        }))
    ctx._fail_submits(replay_puts=False)  # the give-up sweep

    evs = [
        e for e in events.snapshot()
        if e["type"] == "core.object.poison" and e.get("oid") == oid.hex()
    ]
    assert evs, "give-up sweep emitted no core.object.poison event"
    assert evs[-1]["reason"] == "conn-lost"

    ref = ObjectRef(oid, owned=True)
    # plain try/except, not pytest.raises: the raised error IS the
    # _poisoned entry, and excinfo would pin its traceback (whose frames
    # reference the ref) past the del below
    try:
        ray_tpu_torch.get(ref, timeout=5)
    except rex.RayError:
        pass
    else:
        pytest.fail("get on a poisoned ref did not raise")
    assert oid in ctx._poisoned
    del ref
    gc.collect()
    assert oid not in ctx._poisoned, "ref drop must clear the poison entry"


def test_poisoned_ref_folds_into_ledger_until_drop(ray_start_regular):
    """The ledger shows a client-side poisoned ref as state ``poisoned``
    (worker/driver reports folded in) until the ref drops."""
    from ray_tpu_torch._private.runtime import ObjectID

    ctx = get_ctx()
    oid = ObjectID.for_put().binary()
    ctx._poisoned[oid] = rex.RayError("submit window lost")
    try:
        led = ctx.call("object_ledger", timeout=0.0)
        mine = [p for p in led["poisoned"] if p["object_id"] == oid.hex()]
        assert mine and mine[0]["state"] == "poisoned"
        assert mine[0]["node"] == "head"
        assert led["summary"]["poisoned"] >= 1
    finally:
        ctx._poisoned.pop(oid, None)
    led = ctx.call("object_ledger", timeout=0.0)
    assert not [p for p in led["poisoned"] if p["object_id"] == oid.hex()]


def test_object_ledger_states_and_freed_tail(ray_start_regular):
    """Directory rows carry state/node/size/age; a freed object lands in
    the forensics tail with its lifetime and reason."""
    ctx = get_ctx()
    blob = np.ones(64 * 1024, np.uint8)  # shm band
    ref = ray_tpu_torch.put(blob)
    small = ray_tpu_torch.put(b"tiny")  # inline band
    led = ctx.call("object_ledger", timeout=0.0)
    by_id = {r["object_id"]: r for r in led["objects"]}
    row = by_id[ref.binary().hex()]
    assert row["state"] in ("arena", "segment")
    assert row["size"] >= blob.nbytes
    assert row["age_s"] >= 0.0 and row["seg"]
    assert by_id[small.binary().hex()]["state"] == "inline"
    assert led["summary"]["by_state"].get("inline", 0) >= 1
    assert "head" in led["nodes"]
    assert led["nodes"]["head"]["capacity"] > 0

    freed_hex = ref.binary().hex()
    del ref
    gc.collect()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        led = ctx.call("object_ledger", timeout=0.0)
        hits = [f for f in led["freed"] if f["object_id"] == freed_hex]
        if hits:
            assert hits[0]["reason"] == "refcount"
            assert hits[0]["size"] >= blob.nbytes
            break
        time.sleep(0.1)
    else:
        pytest.fail("freed object never reached the forensics tail")


def test_audit_clean_after_sigkill_chaos_then_detects_injected_orphan(
    p2p_cluster,
):
    """The acceptance invariant: after producer-SIGKILL chaos the audit
    reports ZERO leaks — every owner-registered byte has a live locator,
    every spill file a spilled entry — and a deliberately injected
    orphan (the test-only hook registers real bytes with no directory
    entry, exactly what a producer SIGKILLed after its put landed
    leaves) is detected with node + object provenance."""
    ray_tpu_torch.init(address=p2p_cluster["address"])
    ctx = get_ctx()

    @ray_tpu_torch.remote(resources={"nodeA": 1.0})
    def produce():
        ref = ray_tpu_torch.put(np.full(32 * 1024, 7, dtype=np.int64))
        return os.getpid(), ref

    pid, ref = ray_tpu_torch.get(produce.remote(), timeout=60)
    os.kill(pid, signal.SIGKILL)  # producer dies, its arena blocks live on
    time.sleep(0.5)
    out = ray_tpu_torch.get(ref, timeout=60)
    assert (out[::1024] == 7).all()
    # head-side churn too: locators the head itself lays out and frees
    churn = [ray_tpu_torch.put(np.ones(200 * 1024, np.uint8)) for _ in range(3)]
    for r in churn:
        assert ray_tpu_torch.get(r, timeout=30).nbytes == 200 * 1024

    audit = ctx.call("object_audit", timeout=1.0)
    assert audit["findings"] == [], audit["findings"]
    assert audit["checked"]["objects"] >= 2

    inj = ctx.call("inject_orphan_for_tests", size=8192)
    audit = ctx.call("object_audit", timeout=1.0)
    orphans = [
        f for f in audit["findings"]
        if f["kind"] == "orphaned-bytes"
        and f["seg"] == inj["seg"] and f["offset"] == inj["offset"]
    ]
    assert orphans, f"injected orphan not reported: {audit['findings']}"
    assert orphans[0]["node"] == "head"
    assert orphans[0]["size"] == inj["size"]
