// Shared-memory object arena — the native core of the host object store.
//
// TPU-native counterpart of the reference's plasma store
// (src/ray/object_manager/plasma/store.h:55, dlmalloc over mmap +
// eviction_policy.cc pinning): one POSIX shm segment per host holding a
// boundary-tag heap, shared by every local process. Differences from plasma
// are deliberate TPU-first simplifications:
//
//   * no store daemon and no socket protocol — producers allocate directly
//     under a process-shared robust mutex; consumers map the segment once
//     and read zero-copy (plasma's create/seal/get round-trips disappear),
//   * object lifetime stays with the Python head (it calls free); the arena
//     only enforces *safety*: each block carries a generation + pin count so a
//     reader can atomically pin-if-still-alive, and frees of pinned blocks
//     defer until the last unpin (plasma: client refcount pinning).
//
// Layout:  [ArenaHeader][Block payload][Block payload]...
// All offsets are from the segment base; payload offsets are what the API
// hands out. Blocks are 64-byte aligned; physical neighbours found via
// size (forward) and prev_off (backward) for O(1) free-time coalescing.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Bumped (v2) when the segment layout gained the live-header bitmap, so a
// stale pre-bitmap segment left in /dev/shm can never be attached.
constexpr uint64_t kMagic = 0x52544e4152454e42ull;  // "RTNARENB"
constexpr uint64_t kAlign = 64;

// Block.state word: [ generation:43 | zombie:1 | pins:20 ]
constexpr uint64_t kPinMask = (1ull << 20) - 1;
constexpr uint64_t kZombieBit = 1ull << 20;
constexpr uint64_t kGenShift = 21;

inline uint64_t align_up(uint64_t n) { return (n + kAlign - 1) & ~(kAlign - 1); }

struct Block {
  uint64_t size;      // payload capacity, multiple of 64
  uint64_t prev_off;  // offset of physical predecessor's Block (0 = first)
  uint64_t is_free;   // 1 = on free path (not allocated)
  std::atomic<uint64_t> state;  // generation | zombie | pin count
  uint8_t _pad[kAlign - 32];
};
static_assert(sizeof(Block) == kAlign, "block header must be one cache line");

struct ArenaHeader {
  uint64_t magic;
  uint64_t size;        // whole segment size
  uint64_t first_block; // offset of the first Block
  uint64_t bitmap_off;  // offset of the live-header bitmap (1 bit / 64B line)
  std::atomic<uint64_t> used;      // allocated payload bytes
  std::atomic<uint64_t> n_objects; // live allocations
  std::atomic<uint64_t> gen;       // generation counter
  pthread_mutex_t lock; // process-shared, robust
  uint8_t _pad[256];
};

struct Handle {
  uint8_t* base;
  uint64_t size;
};

inline ArenaHeader* hdr(Handle* h) { return reinterpret_cast<ArenaHeader*>(h->base); }
inline Block* block_at(Handle* h, uint64_t off) {
  return reinterpret_cast<Block*>(h->base + off);
}
// Payload offset <-> block offset.
inline uint64_t payload_of(uint64_t block_off) { return block_off + sizeof(Block); }
inline uint64_t block_of(uint64_t payload_off) { return payload_off - sizeof(Block); }
inline uint64_t next_off(Handle* h, uint64_t off) {
  Block* b = block_at(h, off);
  uint64_t n = off + sizeof(Block) + b->size;
  return n >= hdr(h)->size ? 0 : n;
}

// Live-header bitmap: bit (block_off / kAlign) is set iff that 64-byte line
// is the header of a currently-ALLOCATED block. Mutated and read only under
// the arena mutex, so plain (non-atomic) words suffice. This is what lets
// rta_pin reject a stale payload offset that, after a free + coalesce/split,
// now lands inside some other live object's payload — without it the
// generation check would be reading (and on a 43-bit coincidence, CASing)
// arbitrary payload bytes.
inline uint64_t* bitmap_word(Handle* h, uint64_t block_off, uint64_t* mask) {
  uint64_t idx = block_off / kAlign;
  *mask = 1ull << (idx & 63);
  return reinterpret_cast<uint64_t*>(h->base + hdr(h)->bitmap_off) + (idx >> 6);
}
inline void bitmap_set(Handle* h, uint64_t block_off) {
  uint64_t mask;
  uint64_t* w = bitmap_word(h, block_off, &mask);
  *w |= mask;
}
inline void bitmap_clear(Handle* h, uint64_t block_off) {
  uint64_t mask;
  uint64_t* w = bitmap_word(h, block_off, &mask);
  *w &= ~mask;
}
inline bool bitmap_test(Handle* h, uint64_t block_off) {
  uint64_t mask;
  uint64_t* w = bitmap_word(h, block_off, &mask);
  return (*w & mask) != 0;
}

class MutexGuard {
 public:
  explicit MutexGuard(pthread_mutex_t* m) : m_(m) {
    int rc = pthread_mutex_lock(m_);
    if (rc == EOWNERDEAD) pthread_mutex_consistent(m_);  // holder died; state is
    // consistent by construction: allocator mutations below are ordered so a
    // torn update at worst leaks one block.
  }
  ~MutexGuard() { pthread_mutex_unlock(m_); }

 private:
  pthread_mutex_t* m_;
};

// Merge b with its physical successor if that successor is free.
void try_merge_next(Handle* h, uint64_t off) {
  uint64_t n = next_off(h, off);
  if (n == 0) return;
  Block* b = block_at(h, off);
  Block* nb = block_at(h, n);
  if (!nb->is_free) return;
  b->size += sizeof(Block) + nb->size;
  uint64_t nn = next_off(h, off);
  if (nn != 0) block_at(h, nn)->prev_off = off;
}

void free_block_locked(Handle* h, uint64_t off) {
  Block* b = block_at(h, off);
  hdr(h)->used.fetch_sub(b->size, std::memory_order_relaxed);
  hdr(h)->n_objects.fetch_sub(1, std::memory_order_relaxed);
  bitmap_clear(h, off);
  b->is_free = 1;
  try_merge_next(h, off);
  uint64_t p = b->prev_off;
  if (p != 0 && block_at(h, p)->is_free) {
    try_merge_next(h, p);
  }
}

}  // namespace

extern "C" {

// Create a fresh arena segment. Returns handle or nullptr (errno set).
void* rta_create(const char* name, uint64_t size) {
  size = align_up(size);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  auto* h = new Handle{static_cast<uint8_t*>(base), size};
  ArenaHeader* a = hdr(h);
  a->size = size;
  a->bitmap_off = align_up(sizeof(ArenaHeader));
  // One bit per 64-byte line over the whole segment (fresh shm is
  // zero-filled, so the bitmap starts all-clear).
  uint64_t bitmap_bytes = (size / kAlign + 7) / 8;
  a->first_block = align_up(a->bitmap_off + bitmap_bytes);
  a->used.store(0);
  a->n_objects.store(0);
  a->gen.store(1);
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&a->lock, &attr);
  pthread_mutexattr_destroy(&attr);
  Block* first = block_at(h, a->first_block);
  first->size = size - a->first_block - sizeof(Block);
  first->prev_off = 0;
  first->is_free = 1;
  first->state.store(0);
  a->magic = kMagic;  // published last: attachers spin/check on magic
  return h;
}

// Attach to an existing arena. Returns handle or nullptr.
void* rta_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(ArenaHeader)) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  auto* h = new Handle{static_cast<uint8_t*>(base), static_cast<uint64_t>(st.st_size)};
  if (hdr(h)->magic != kMagic) {
    munmap(base, h->size);
    delete h;
    return nullptr;
  }
  return h;
}

// Allocate `size` payload bytes. Returns payload offset (0 = full), and the
// block's generation via *gen_out (used by readers to pin safely).
uint64_t rta_alloc(void* hv, uint64_t size, uint64_t* gen_out) {
  Handle* h = static_cast<Handle*>(hv);
  ArenaHeader* a = hdr(h);
  uint64_t need = align_up(size ? size : 1);
  MutexGuard g(&a->lock);
  uint64_t off = a->first_block;
  while (off != 0) {
    Block* b = block_at(h, off);
    if (b->is_free && b->size >= need) {
      // Split when the remainder can hold a header + one aligned line.
      if (b->size >= need + sizeof(Block) + kAlign) {
        uint64_t rest_off = off + sizeof(Block) + need;
        Block* rest = block_at(h, rest_off);
        rest->size = b->size - need - sizeof(Block);
        rest->prev_off = off;
        rest->is_free = 1;
        rest->state.store(0);
        uint64_t after = next_off(h, rest_off);
        if (after != 0) block_at(h, after)->prev_off = rest_off;
        b->size = need;
      }
      b->is_free = 0;
      uint64_t gen = a->gen.fetch_add(1, std::memory_order_relaxed) + 1;
      b->state.store(gen << kGenShift, std::memory_order_release);
      bitmap_set(h, off);
      a->used.fetch_add(b->size, std::memory_order_relaxed);
      a->n_objects.fetch_add(1, std::memory_order_relaxed);
      if (gen_out) *gen_out = gen;
      return payload_of(off);
    }
    off = next_off(h, off);
  }
  return 0;
}

// Pin a block if it is still the same allocation (generation matches and it
// is not being freed). Returns 1 on success, 0 if the object is gone.
//
// Runs under the arena mutex: the caller-supplied offset may be stale, and
// only the lock + live-header bitmap can prove it still names a block header
// (after a free + coalesce/split it could point into the middle of another
// live object's payload). Holding the lock also excludes rta_free, and the
// zombie-free path in rta_unpin needs the zombie bit (set only under this
// lock), so a plain fetch_add suffices once validation passes. Pins are
// per-get, not per-byte — the uncontended pshared mutex is noise.
int rta_pin(void* hv, uint64_t payload_off, uint64_t gen) {
  Handle* h = static_cast<Handle*>(hv);
  ArenaHeader* a = hdr(h);
  if (payload_off < sizeof(Block)) return 0;
  uint64_t boff = block_of(payload_off);
  if (boff < a->first_block || (boff % kAlign) != 0 ||
      boff + sizeof(Block) > h->size)
    return 0;
  MutexGuard g(&a->lock);
  if (!bitmap_test(h, boff)) return 0;  // not a live allocated header
  Block* b = block_at(h, boff);
  uint64_t cur = b->state.load(std::memory_order_acquire);
  if ((cur >> kGenShift) != gen || (cur & kZombieBit)) return 0;
  b->state.fetch_add(1, std::memory_order_acq_rel);
  return 1;
}

// Drop a pin. If the block was zombied (freed while pinned) and this was the
// last pin, complete the free.
int rta_unpin(void* hv, uint64_t payload_off) {
  Handle* h = static_cast<Handle*>(hv);
  Block* b = block_at(h, block_of(payload_off));
  uint64_t prev = b->state.fetch_sub(1, std::memory_order_acq_rel);
  if ((prev & kPinMask) == 1 && (prev & kZombieBit)) {
    ArenaHeader* a = hdr(h);
    MutexGuard g(&a->lock);
    // Re-check under the lock: another pinner may have raced in between.
    uint64_t cur = b->state.load(std::memory_order_acquire);
    if ((cur & kPinMask) == 0 && (cur & kZombieBit) && !b->is_free) {
      b->state.store(0, std::memory_order_release);
      free_block_locked(h, block_of(payload_off));
    }
  }
  return 0;
}

// Free an allocation. If readers hold pins, the block is zombied and the
// last unpin completes the free. Returns 0 freed now, 1 deferred, -1 gone.
// The state word is claimed by CAS: rta_unpin's fetch_sub runs without the
// mutex, so a plain load+store here could lose a concurrent unpin and free
// a block with corrupted pin bookkeeping.
int rta_free(void* hv, uint64_t payload_off, uint64_t gen) {
  Handle* h = static_cast<Handle*>(hv);
  ArenaHeader* a = hdr(h);
  MutexGuard g(&a->lock);
  Block* b = block_at(h, block_of(payload_off));
  uint64_t cur = b->state.load(std::memory_order_acquire);
  for (;;) {
    if (b->is_free || (cur >> kGenShift) != gen || (cur & kZombieBit)) return -1;
    if ((cur & kPinMask) != 0) {
      if (b->state.compare_exchange_weak(cur, cur | kZombieBit,
                                         std::memory_order_acq_rel))
        return 1;  // readers active: the last unpin completes the free
      continue;    // a pin/unpin raced in; re-evaluate
    }
    // CAS to 0 claims the block iff still exactly (gen, no pins, no zombie);
    // a concurrent pin changes the word and the CAS retries.
    if (b->state.compare_exchange_weak(cur, 0, std::memory_order_acq_rel)) {
      free_block_locked(h, block_of(payload_off));
      return 0;
    }
  }
}

uint64_t rta_used(void* hv) { return hdr(static_cast<Handle*>(hv))->used.load(); }
uint64_t rta_segment_size(void* hv) { return static_cast<Handle*>(hv)->size; }
uint64_t rta_capacity(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  return h->size - hdr(h)->first_block;
}
uint64_t rta_n_objects(void* hv) {
  return hdr(static_cast<Handle*>(hv))->n_objects.load();
}
// Base address of the mapping (payload pointers = base + payload offset).
void* rta_base(void* hv) { return static_cast<Handle*>(hv)->base; }

void rta_detach(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  munmap(h->base, h->size);
  delete h;
}

int rta_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
