"""The port's runtime against the reference's tests: a mirror of
``tests/test_native_arena.py`` run on ``ray_tpu_torch``, with no wall-clock bar
and without the tests of modules still to port.

Native shared-memory arena (ray_tpu_torch/_native/arena.cc) — the plasma
equivalent (reference: src/ray/object_manager/plasma/store.h:55, eviction
pinning in eviction_policy.cc).

Unit-tests the allocator directly (alloc/free/coalesce, pin/zombie
protocol) and the store integration (arena-placed objects round-tripping
through put/get, refcount-driven frees returning bytes to the arena).
"""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import _native

pytestmark = pytest.mark.skipif(
    _native.load() is None, reason="native arena unavailable (no g++?)"
)


# The port's counterparts of the reference's conftest fixtures (a fresh
# single-node cluster per test).
@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.init(num_cpus=4, num_tpus=0)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def arena():
    a = _native.Arena.create(f"/rta-test-{os.getpid()}-{os.urandom(4).hex()}", 1 << 22)
    assert a is not None
    yield a
    a.unlink()


class TestAllocator:
    def test_alloc_write_read(self, arena):
        off, gen = arena.alloc(1000)
        arena.view(off, 1000)[:] = b"a" * 1000
        assert bytes(arena.view(off, 4)) == b"aaaa"
        assert arena.free(off, gen) == 0
        assert arena.used == 0

    def test_cross_handle_visibility(self, arena):
        off, gen = arena.alloc(64)
        arena.view(off, 4)[:] = b"xyzw"
        other = _native.Arena.attach(arena.name)
        assert bytes(other.view(off, 4)) == b"xyzw"

    def test_full_arena_returns_none(self, arena):
        assert arena.alloc(arena.capacity * 2) is None
        r = arena.alloc(arena.capacity - 64)  # exactly fills (64B block header)
        assert r is not None
        assert arena.alloc(64) is None
        assert arena.free(*r) == 0

    def test_coalescing(self, arena):
        # fill with thirds, free all, then the whole space is one block again
        a = arena.alloc(1 << 20)
        b = arena.alloc(1 << 20)
        c = arena.alloc(1 << 20)
        for r in (b, a, c):  # free middle first: exercises both-side merges
            assert arena.free(*r) == 0
        assert arena.used == 0
        big = arena.alloc(arena.capacity - 64)
        assert big is not None
        arena.free(*big)

    def test_churn_no_leak(self, arena):
        import random

        rng = random.Random(7)
        live = []
        for _ in range(500):
            if live and rng.random() < 0.5:
                off, gen = live.pop(rng.randrange(len(live)))
                assert arena.free(off, gen) == 0
            else:
                r = arena.alloc(rng.randrange(100, 60_000))
                if r is None:
                    off, gen = live.pop(0)
                    assert arena.free(off, gen) == 0
                else:
                    live.append(r)
        for off, gen in live:
            assert arena.free(off, gen) == 0
        assert arena.used == 0 and arena.n_objects == 0

    def test_stale_generation_refused(self, arena):
        off, gen = arena.alloc(128)
        assert arena.free(off, gen) == 0
        off2, gen2 = arena.alloc(128)  # reuses the same block
        assert off2 == off and gen2 != gen
        assert not arena.pin(off, gen)  # old identity is dead
        assert arena.free(off, gen) == -1
        assert arena.free(off2, gen2) == 0

    def test_free_defers_until_unpin(self, arena):
        off, gen = arena.alloc(256)
        assert arena.pin(off, gen)
        assert arena.free(off, gen) == 1  # deferred: reader holds a pin
        assert not arena.pin(off, gen)  # zombied: no new pins
        used_before = arena.used
        arena.unpin(off)  # last unpin completes the free
        assert arena.used < used_before
        assert arena.n_objects == 0


@pytest.fixture
def small_arena_cluster():
    """Cluster whose arena is tiny (1 MiB) so exhaustion paths trigger."""
    import ray_tpu_torch
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    old = GLOBAL_CONFIG.object_store_arena_bytes
    ray_tpu_torch.init(num_cpus=2, _system_config={"object_store_arena_bytes": 1 << 20})
    yield
    ray_tpu_torch.shutdown()
    GLOBAL_CONFIG.object_store_arena_bytes = old


class TestStoreIntegration:
    def test_arena_objects_roundtrip(self, ray_start_regular):
        import ray_tpu_torch
        from ray_tpu_torch._private import shm_store

        assert shm_store._write_arena_name, "head should have created an arena"

        @ray_tpu_torch.remote
        def make(n):
            return np.arange(n, dtype=np.int64)

        # >100KiB direct-call limit, <=256KiB arena cap -> arena placement
        n = 20_000
        ref = make.remote(n)
        v = ray_tpu_torch.get(ref)
        assert v[-1] == n - 1
        arena = shm_store.attach_arena(shm_store._write_arena_name)
        assert arena.n_objects >= 1

        # freeing the ref returns the bytes to the allocator
        del ref, v
        import gc

        gc.collect()
        import time

        for _ in range(50):
            if arena.n_objects == 0:
                break
            time.sleep(0.1)
        assert arena.n_objects == 0

    def test_large_objects_use_dedicated_segments(self, ray_start_regular):
        """Objects above arena_max_object_bytes (64 MB — large objects
        recycle warmed arena pages for write throughput, see config.py) get
        a dedicated POSIX segment."""
        import ray_tpu_torch
        from ray_tpu_torch._private import shm_store
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        arena = shm_store.attach_arena(shm_store._write_arena_name)
        n = GLOBAL_CONFIG.arena_max_object_bytes // 8 + 1_000_000
        before = arena.n_objects
        ref = ray_tpu_torch.put(np.zeros(n))  # just over the arena object cap
        assert ray_tpu_torch.get(ref).shape == (n,)
        assert arena.n_objects == before  # did not land in the arena

    def test_medium_objects_recycle_arena_pages(self, ray_start_regular):
        """A 10 MB object lands in the arena (zero-copy pinned reads; write
        path recycles faulted pages instead of paying per-put page faults)."""
        import ray_tpu_torch
        from ray_tpu_torch._private import shm_store

        arena = shm_store.attach_arena(shm_store._write_arena_name)
        before = arena.n_objects
        src = np.arange(1_250_000, dtype=np.float64)  # 10 MB
        ref = ray_tpu_torch.put(src)
        assert arena.n_objects == before + 1
        out = ray_tpu_torch.get(ref)
        assert (out[::100_000] == src[::100_000]).all()
        # zero-copy: the value's buffer lives in the shared mapping, and the
        # block stays pinned (a free would defer) while the view is alive
        del out
        del ref  # free the object; block returns to the allocator
        import gc

        gc.collect()
        deadline = 300  # the free lands asynchronously; wait up to 30 s under load
        while arena.n_objects != before and deadline:
            import time

            time.sleep(0.1)
            deadline -= 1
        assert arena.n_objects == before

    def test_arena_exhaustion_falls_back(self, small_arena_cluster):
        """When the arena fills, writes degrade to dedicated segments."""
        import ray_tpu_torch
        from ray_tpu_torch._private import shm_store

        refs = [ray_tpu_torch.put(np.zeros(25_000)) for _ in range(40)]  # 200KB each
        vals = ray_tpu_torch.get(refs)
        assert all(v.shape == (25_000,) for v in vals)
        arena = shm_store.attach_arena(shm_store._write_arena_name)
        # 40 x 200KB = 8MB >> 1MiB arena -> most fell back to segments
        assert arena.used <= arena.capacity
