// shm_store.cpp — node-local shared-memory object store (lock-striped).
//
// TPU-native re-design of the reference's plasma store
// (reference: src/ray/object_manager/plasma/store.cc, plasma_allocator.h).
// Unlike plasma (a store *server* that clients reach over a unix socket with
// fd-passing), the entire store — allocator, object table, LRU — lives in one
// file-backed shared-memory arena that every process on the node maps at a
// known path. create/seal/get/release are direct shared-memory operations:
// no socket round trip, no fd passing. The node daemon only coordinates
// spill-to-disk, eviction sweeps and cross-node transfer.
//
// Concurrency model (v2): the arena is striped into independently locked
// sub-heaps so N same-node clients putting in parallel never rendezvous on
// one mutex:
//
//   - Each stripe owns a contiguous heap slice AND a contiguous segment of
//     the object table, protected by its own robust process-shared mutex.
//     An object's entry and its payload always live in the SAME stripe, so
//     crash repair of one stripe never chases pointers into another.
//   - Allocation hashes the object id to a home stripe; when the home heap
//     is full the create falls back round-robin to the next stripe (the
//     object is re-homed there entirely). The sealed-put fast path
//     (create + copy + seal) takes exactly ONE stripe lock: the create.
//   - rt_seal is a lock-free atomic entry-state transition
//     (CREATED -> SEALED via CAS); the payload copy between create and
//     seal never held a lock to begin with.
//   - rt_stats / rt_stripe_stats read a seqlock-style per-stripe snapshot
//     (lockseq is odd while a locked mutation is open) and acquire a mutex
//     only if a writer appears stuck — which doubles as the robust-mutex
//     recovery probe for holders that died mid-mutation.
//   - LRU is a per-entry sequence stamp, not a linked list: eviction scans
//     the stripe's table segment and frees lowest-seq sealed unpinned
//     entries. Sweeps are driven by the node manager per stripe; the
//     in-create eviction fallback only ever locks the one stripe it is
//     allocating from, so one client's arena pressure cannot stall every
//     other client's create.
//   - A client killed while holding a stripe mutex poisons only that
//     stripe: the next locker gets EOWNERDEAD, marks the mutex consistent
//     and rebuilds the stripe (table segment + heap reset; resident objects
//     there are lost, equivalent to eviction). The other stripes keep
//     serving throughout.
//
// Spanning objects (v3): an object larger than one stripe's heap cannot
// live in any stripe, so weight-sized blobs (sharded checkpoints, RL
// weight pushes, cold-start attach) take the SPANNING path instead:
//
//   - The span claims m = ceil(need / stripe_bytes) physically
//     CONTIGUOUS whole stripes (stripe i+1's heap starts exactly where
//     stripe i's ends, so the payload is one contiguous region). Claimed
//     stripes are marked span_owner and excluded from normal creates,
//     per-stripe eviction and segment probing; their resident objects
//     are LRU-evicted during the claim (pinned residents fail the
//     window and the claim slides to the next one).
//   - Span descriptors live in a small header-level table guarded by
//     their own robust process-shared mutex (spans are few and huge; a
//     single lock is never the bottleneck). The entry/payload
//     colocation rule extends naturally: the descriptor IS the entry,
//     and crash repair frees or invalidates the WHOLE span atomically —
//     a poisoned member stripe marks the span broken, and broken spans
//     are reclaimed (all member stripes at once) by the span-mutex
//     repair path, the gc sweep and allocation pressure. LRU pressure
//     can evict a whole unpinned span but can never half-free one.
//   - rt_create routes by size (need > one stripe -> span path), so the
//     Python client and every put/transfer path gains multi-GB objects
//     transparently; rt_create_spanning forces the path for tests.
//
// Layout:
//   [Header incl. Stripe[] + SpanDesc[] | ObjectTable | striped arena]
//
// Object lifecycle: CREATED (writer owns buffer) -> SEALED (immutable,
// readable by all) -> deleted (deferred until pin_count drops to zero).

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5250555453544f52ULL;  // "RPUTSTOR"
constexpr uint32_t kVersion = 3;
constexpr uint32_t kIdLen = 20;
constexpr uint32_t kTableCapacity = 1 << 16;  // 65536 entries total
constexpr uint64_t kAlign = 64;
constexpr uint32_t kNil = 0xffffffffu;
constexpr uint32_t kMaxStripes = 16;
// Auto-striping floor: a stripe must comfortably hold the largest common
// object (64 MiB bench blobs, multi-MB KV blocks) with room to recycle.
constexpr uint64_t kMinStripeBytes = 128ULL << 20;

// Object states.
enum : uint32_t { kEmpty = 0, kCreated = 1, kSealed = 2, kTombstone = 3 };

// Span descriptor states. kSpanClaiming is only ever observed by crash
// repair: a live claim holds the span mutex for its whole duration, so
// any claiming slot seen by a span-mutex holder belongs to a dead writer.
constexpr uint32_t kMaxSpans = 16;
enum : uint32_t {
  kSpanEmpty = 0,
  kSpanClaiming = 1,
  kSpanCreated = 2,
  kSpanSealed = 3,
  kSpanBroken = 4,
};

// --------------------------------------------------------------- atomics
// Shared-memory fields are plain integers accessed through __atomic
// builtins (std::atomic members are not guaranteed address-free across
// processes by the standard; the builtins are, on this ABI, and tsan
// models them).

// ThreadSanitizer annotations for the seqlock protocol (build:tsan
// analog — tests/test_sanitizers.py runs the striped hammer under
// -fsanitize=thread). Every seqlock-covered field is itself accessed
// through the __atomic builtins above, so tsan already derives the
// happens-before edges from the atomics; these annotations make the
// publication edge EXPLICIT at the protocol level (writer's closing
// lockseq bump releases, reader's validated snapshot acquires), so a
// future relaxation of a field load to a plain read is still anchored
// to the seqlock rather than silently racing.
#if defined(__SANITIZE_THREAD__)
#define RT_TSAN 1
#elif defined(__has_feature)
#if __has_feature(thread_sanitizer)
#define RT_TSAN 1
#endif
#endif
#ifdef RT_TSAN
extern "C" void __tsan_acquire(void* addr);
extern "C" void __tsan_release(void* addr);
#define RT_TSAN_ACQUIRE(p) __tsan_acquire((void*)(p))
#define RT_TSAN_RELEASE(p) __tsan_release((void*)(p))
#else
#define RT_TSAN_ACQUIRE(p) ((void)0)
#define RT_TSAN_RELEASE(p) ((void)0)
#endif
inline uint32_t ld32(const uint32_t* p, int mo = __ATOMIC_ACQUIRE) {
  return __atomic_load_n(p, mo);
}
inline uint64_t ld64(const uint64_t* p, int mo = __ATOMIC_ACQUIRE) {
  return __atomic_load_n(p, mo);
}
inline void st32(uint32_t* p, uint32_t v, int mo = __ATOMIC_RELEASE) {
  __atomic_store_n(p, v, mo);
}
inline void st64(uint64_t* p, uint64_t v, int mo = __ATOMIC_RELEASE) {
  __atomic_store_n(p, v, mo);
}
inline uint64_t add64(uint64_t* p, uint64_t v, int mo = __ATOMIC_ACQ_REL) {
  return __atomic_fetch_add(p, v, mo);
}
inline bool cas32(uint32_t* p, uint32_t expected, uint32_t desired) {
  return __atomic_compare_exchange_n(p, &expected, desired, false,
                                     __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE);
}

struct Entry {
  uint8_t id[kIdLen];
  uint32_t state;      // atomic; publishes the entry (release on CREATED)
  uint32_t stripe;     // owning stripe == segment holding this slot
  uint64_t offset;     // payload offset, relative to the stripe's heap base
  uint64_t data_size;
  uint64_t meta_size;
  uint32_t pin_count;  // mutated under the stripe lock (seal resets it
                       // lock-free BEFORE the SEALED transition publishes)
  uint32_t flags;      // bit0: delete-pending, bit1: not-evictable
  uint64_t seq;        // LRU stamp (stripe lru_clock value at last touch)
  uint64_t ctime_sec;  // CLOCK_MONOTONIC seconds at creation
};

struct alignas(64) Stripe {
  pthread_mutex_t mutex;     // robust, process-shared
  uint32_t mutating;         // a locked mutation is in progress
  uint32_t poisoned;         // set transiently when a holder died mid-mutation
  uint32_t span_owner;       // 0 = none, else owning span slot + 1: the whole
                             // heap slice belongs to that spanning object
  uint32_t _pad1;
  uint64_t lockseq;          // seqlock: odd while a locked section is open
  uint64_t arena_off;        // base-relative start of this stripe's heap
  uint64_t arena_size;
  uint64_t free_head;        // stripe-relative offset of first free block
  uint64_t bytes_in_use;     // allocated bytes incl. block headers
  uint64_t num_objects;
  uint64_t lru_clock;        // atomic (lock-free seal stamps through it)
  uint64_t num_evictions;
  uint64_t bytes_evicted;
  uint64_t create_count;
  uint64_t seal_count;       // atomic (lock-free seal)
  uint64_t get_hits;
  uint64_t get_misses;       // atomic (lock-free miss path)
  uint64_t repairs;          // robust-mutex crash repairs of this stripe
  uint32_t seg_start, seg_len;  // entry-table segment [start, start+len)
};

// Descriptor for one spanning object: the payload occupies the whole
// contiguous heap slices of stripes [first_stripe, first_stripe +
// n_stripes). Descriptors mutate only under the header's robust span
// mutex; `state` is the atomic publication field (release-stored so a
// lock-free reader that observes CREATED/SEALED sees consistent fields).
struct SpanDesc {
  uint8_t id[kIdLen];
  uint32_t state;        // atomic (see enum above)
  uint32_t first_stripe;
  uint32_t n_stripes;
  uint32_t pin_count;    // mutated under the span mutex
  uint32_t flags;        // bit0: delete-pending, bit1: not-evictable
  uint32_t _pad;
  uint64_t data_size;
  uint64_t meta_size;
  uint64_t seq;          // LRU stamp (header span_clock value at last touch)
  uint64_t ctime_sec;    // CLOCK_MONOTONIC seconds at creation
};

struct Header {
  uint64_t magic;
  uint32_t version;
  uint32_t table_capacity;
  uint64_t total_size;       // whole mapping size
  uint64_t arena_offset;     // start of heap area (base-relative)
  uint64_t arena_size;       // raw heap area size (>= sum of stripe slices)
  uint32_t num_stripes;
  uint32_t _pad0;
  uint64_t fallback_count;   // atomic: creates re-homed off their hash stripe
  // ------------------------------------------------ spanning allocation
  pthread_mutex_t span_mutex;  // robust, process-shared; guards spans[]
  uint32_t span_mutating;      // a locked span mutation is in progress
  uint32_t _pad2;
  uint64_t span_clock;         // LRU clock for spans (under span mutex)
  uint64_t span_creates;       // lifetime spans successfully created
  uint64_t span_evictions;     // whole spans reclaimed under LRU pressure
  uint64_t span_repairs;       // atomic: crash repairs that broke a span
  SpanDesc spans[kMaxSpans];
  Stripe stripes[kMaxStripes];
};

// Boundary-tag heap block, located in a stripe's heap slice. Offsets in
// the free list are stripe-relative. Size includes the header.
struct Block {
  uint64_t size;       // total block size incl. header; low bit = free flag
  uint64_t prev_size;  // size of physically-previous block (0 if first)
  // free blocks only:
  uint64_t next_free;  // stripe-relative offset or ~0
  uint64_t prev_free;  // stripe-relative offset or ~0
};

constexpr uint64_t kBlockHeader = 16;  // size + prev_size (used blocks)
constexpr uint64_t kMinBlock = 64;
constexpr uint64_t kNone = ~0ULL;

struct Store {
  Header* hdr;
  uint8_t* base;     // mapping base
  Entry* table;
  uint64_t map_size;
  int fd;
};

inline uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }
inline bool blk_free(Block* b) { return b->size & 1; }
inline uint64_t blk_size(Block* b) { return b->size & ~1ULL; }
inline void set_size(Block* b, uint64_t s, bool f) { b->size = s | (f ? 1 : 0); }

inline Block* at(Store* s, Stripe* sp, uint64_t off) {
  return reinterpret_cast<Block*>(s->base + sp->arena_off + off);
}
inline uint64_t off_of(Store* s, Stripe* sp, Block* b) {
  return reinterpret_cast<uint8_t*>(b) - (s->base + sp->arena_off);
}

void free_list_push(Store* s, Stripe* sp, Block* b) {
  uint64_t off = off_of(s, sp, b);
  b->next_free = sp->free_head;
  b->prev_free = kNone;
  if (sp->free_head != kNone) at(s, sp, sp->free_head)->prev_free = off;
  sp->free_head = off;
}

void free_list_remove(Store* s, Stripe* sp, Block* b) {
  if (b->prev_free != kNone)
    at(s, sp, b->prev_free)->next_free = b->next_free;
  else
    sp->free_head = b->next_free;
  if (b->next_free != kNone) at(s, sp, b->next_free)->prev_free = b->prev_free;
}

Block* phys_next(Store* s, Stripe* sp, Block* b) {
  uint64_t off = off_of(s, sp, b) + blk_size(b);
  if (off >= sp->arena_size) return nullptr;
  return at(s, sp, off);
}

Block* phys_prev(Store* s, Stripe* sp, Block* b) {
  if (b->prev_size == 0) return nullptr;
  return at(s, sp, off_of(s, sp, b) - b->prev_size);
}

// Allocate `need` payload bytes from one stripe's heap; returns
// stripe-relative offset of payload or kNone. Caller holds the stripe lock.
uint64_t heap_alloc(Store* s, Stripe* sp, uint64_t need) {
  uint64_t want = align_up(need + kBlockHeader, kAlign);
  if (want < kMinBlock) want = kMinBlock;
  // first-fit
  uint64_t off = sp->free_head;
  while (off != kNone) {
    Block* b = at(s, sp, off);
    uint64_t bs = blk_size(b);
    if (bs >= want) {
      free_list_remove(s, sp, b);
      if (bs - want >= kMinBlock) {
        // split
        Block* rest = at(s, sp, off + want);
        set_size(rest, bs - want, true);
        rest->prev_size = want;
        Block* nxt = phys_next(s, sp, rest);
        if (nxt) nxt->prev_size = blk_size(rest);
        free_list_push(s, sp, rest);
        set_size(b, want, false);
      } else {
        set_size(b, bs, false);
      }
      sp->bytes_in_use += blk_size(b);
      return off + kBlockHeader;
    }
    off = b->next_free;
  }
  return kNone;
}

void heap_free(Store* s, Stripe* sp, uint64_t payload_off) {
  Block* b = at(s, sp, payload_off - kBlockHeader);
  sp->bytes_in_use -= blk_size(b);
  set_size(b, blk_size(b), true);
  // coalesce with next
  Block* n = phys_next(s, sp, b);
  if (n && blk_free(n)) {
    free_list_remove(s, sp, n);
    set_size(b, blk_size(b) + blk_size(n), true);
  }
  // coalesce with prev
  Block* p = phys_prev(s, sp, b);
  if (p && blk_free(p)) {
    free_list_remove(s, sp, p);
    set_size(p, blk_size(p) + blk_size(b), true);
    b = p;
  }
  Block* after = phys_next(s, sp, b);
  if (after) after->prev_size = blk_size(b);
  free_list_push(s, sp, b);
}

inline uint64_t hash_id(const uint8_t* id) {
  // Mix all 20 bytes: ids that share a task prefix differ only in the
  // trailing index word, so the tail must feed the hash.
  uint64_t a, b;
  uint32_t c;
  memcpy(&a, id, 8);
  memcpy(&b, id + 8, 8);
  memcpy(&c, id + 16, 4);
  uint64_t h = a ^ (b * 0x9e3779b97f4a7c15ULL) ^ ((uint64_t)c << 17);
  h ^= h >> 33; h *= 0xff51afd7ed558ccdULL; h ^= h >> 33;
  return h;
}

inline uint32_t stripe_of(Store* s, uint64_t h) {
  // high bits pick the stripe; low bits pick the slot within the segment
  return (uint32_t)((h >> 40) % s->hdr->num_stripes);
}

inline uint32_t segment_of(Store* s, uint32_t idx) {
  return idx / s->hdr->stripes[0].seg_len;
}

// Probe one stripe's table segment for id. Safe WITHOUT the stripe lock:
// entries publish via a release-store of state, ids are immutable while an
// entry is live, and a concurrent tombstone compaction can at worst cause
// a spurious miss (callers confirm misses under the lock). Returns entry
// index or kNil.
uint32_t probe_segment(Store* s, uint32_t si, const uint8_t* id, uint64_t h) {
  Stripe* sp = &s->hdr->stripes[si];
  uint32_t start = sp->seg_start, len = sp->seg_len;
  uint32_t i = start + (uint32_t)h % len;
  for (uint32_t probe = 0; probe < len; ++probe) {
    Entry* e = &s->table[i];
    uint32_t st = ld32(&e->state);
    if (st == kEmpty) return kNil;
    if (st != kTombstone && memcmp(e->id, id, kIdLen) == 0) return i;
    if (++i == start + len) i = start;
  }
  return kNil;
}

// Find a free slot in a stripe's segment for id (caller holds the stripe
// lock and has verified id is absent). kNil if the segment is full.
uint32_t segment_slot(Store* s, uint32_t si, uint64_t h) {
  Stripe* sp = &s->hdr->stripes[si];
  uint32_t start = sp->seg_start, len = sp->seg_len;
  uint32_t i = start + (uint32_t)h % len;
  for (uint32_t probe = 0; probe < len; ++probe) {
    uint32_t st = ld32(&s->table[i].state, __ATOMIC_RELAXED);
    if (st == kEmpty || st == kTombstone) return i;
    if (++i == start + len) i = start;
  }
  return kNil;
}

// Lock-free find across stripes: home segment first, then — only when any
// create has ever been re-homed — the remaining segments in fallback order.
uint32_t find_lockfree(Store* s, const uint8_t* id, uint64_t h,
                       uint32_t home) {
  uint32_t idx = probe_segment(s, home, id, h);
  if (idx != kNil) return idx;
  if (ld64(&s->hdr->fallback_count, __ATOMIC_RELAXED) == 0) return kNil;
  uint32_t n = s->hdr->num_stripes;
  for (uint32_t k = 1; k < n; ++k) {
    idx = probe_segment(s, (home + k) % n, id, h);
    if (idx != kNil) return idx;
  }
  return kNil;
}

// ----------------------------------------------------- stripe lock guard
void repair_stripe_locked(Store* s, uint32_t si);
class StripeGuard;
template <typename F>
int64_t with_entry_locked(Store* s, const uint8_t* id, F&& fn);

class StripeGuard {
 public:
  StripeGuard(Store* s, uint32_t si) : sp_(&s->hdr->stripes[si]) {
    int rc = pthread_mutex_lock(&sp_->mutex);
    bool dead = rc == EOWNERDEAD;
    if (dead) pthread_mutex_consistent(&sp_->mutex);
    bool need_repair = dead && ld32(&sp_->mutating);
    st32(&sp_->mutating, 1);
    // open the seqlock window (odd) BEFORE any mutation — including the
    // repair below — so seqlock readers can never accept a torn snapshot.
    // A dead holder may have left lockseq odd already; don't double-bump.
    if (!(ld64(&sp_->lockseq) & 1)) add64(&sp_->lockseq, 1);
    if (need_repair) {
      // the dead holder was mid-mutation: heap/table invariants for THIS
      // stripe are suspect — rebuild it instead of walking corrupt
      // structures. Other stripes are untouched.
      st32(&sp_->poisoned, 1);
      repair_stripe_locked(s, si);
      st32(&sp_->poisoned, 0);
    }
  }
  ~StripeGuard() {
    st32(&sp_->mutating, 0);
    // everything mutated in this window is published to seqlock readers
    // by the closing (even) bump — release BEFORE it so the reader's
    // paired acquire in snapshot_stripe() covers the whole window
    RT_TSAN_RELEASE(&sp_->lockseq);
    add64(&sp_->lockseq, 1);  // even: snapshot stable
    pthread_mutex_unlock(&sp_->mutex);
  }

 private:
  Stripe* sp_;
};

// Reset one stripe's heap to a single free block (fresh-store state).
// Caller holds the stripe mutex. Used by crash repair and by span
// claim/free, whose payload writes overwrite the heap's block headers.
void reset_stripe_heap_locked(Store* s, Stripe* sp) {
  sp->free_head = kNone;
  Block* b = at(s, sp, 0);
  set_size(b, sp->arena_size, true);
  b->prev_size = 0;
  b->next_free = kNone;
  b->prev_free = kNone;
  sp->free_head = 0;
  sp->bytes_in_use = 0;
  sp->num_objects = 0;
}

// Rebuild one stripe after its lock holder died mid-mutation: wipe the
// table segment, reset the heap to a single free block. Objects resident
// in the stripe are lost (survivors observe them as evicted — the same
// contract as LRU eviction of an unspilled object). Caller holds the
// (freshly made-consistent) stripe mutex.
void repair_stripe_locked(Store* s, uint32_t si) {
  Stripe* sp = &s->hdr->stripes[si];
  memset(&s->table[sp->seg_start], 0, sizeof(Entry) * (uint64_t)sp->seg_len);
  reset_stripe_heap_locked(s, sp);
  if (sp->span_owner) {
    // the poisoned stripe held part of a spanning object: its payload is
    // gone, so the WHOLE span must die — mark the descriptor broken
    // (lock-free CAS loop: we hold only this stripe's mutex and must not
    // take the span mutex here). The span-mutex repair path, the gc
    // sweep, and allocation pressure all reclaim broken spans' remaining
    // member stripes atomically.
    uint32_t slot = sp->span_owner - 1;
    if (slot < kMaxSpans) {
      SpanDesc* d = &s->hdr->spans[slot];
      for (;;) {
        uint32_t st = ld32(&d->state);
        if (st == kSpanEmpty || st == kSpanBroken) break;
        if (cas32(&d->state, st, kSpanBroken)) {
          add64(&s->hdr->span_repairs, 1, __ATOMIC_RELAXED);
          break;
        }
      }
    }
    sp->span_owner = 0;
  }
  sp->repairs++;
}

// Free an entry's heap block and tombstone its slot. Caller holds the
// stripe lock and has already transitioned state to kTombstone.
void finish_free(Store* s, uint32_t si, uint32_t idx) {
  Stripe* sp = &s->hdr->stripes[si];
  Entry* e = &s->table[idx];
  // Sanity-gate the heap free: a lock-free seal racing a crash repair's
  // segment wipe can leave a resurrected entry with a zeroed offset —
  // freeing that would walk out of the stripe's heap. Such an entry owns
  // no block (the repair rebuilt the heap), so only the slot dies.
  if (e->offset >= kBlockHeader && e->offset < sp->arena_size)
    heap_free(s, sp, e->offset);
  if (sp->num_objects > 0) sp->num_objects--;  // resurrected entries (see
                                               // above) aren't counted
  // Anti-tombstone-exhaustion: if the next probe slot (within the
  // segment) is empty, this tombstone and any run before it can revert
  // to empty without breaking probe chains.
  uint32_t start = sp->seg_start, len = sp->seg_len;
  uint32_t nxt = idx + 1 == start + len ? start : idx + 1;
  if (ld32(&s->table[nxt].state, __ATOMIC_RELAXED) == kEmpty) {
    uint32_t j = idx;
    while (ld32(&s->table[j].state, __ATOMIC_RELAXED) == kTombstone) {
      st32(&s->table[j].state, kEmpty);
      j = j == start ? start + len - 1 : j - 1;
    }
  }
}

// CAS the entry out of `from` and free it. Returns false when the state
// moved under us (e.g. a lock-free seal won the race against gc).
bool entry_free_from(Store* s, uint32_t si, uint32_t idx, uint32_t from) {
  if (!cas32(&s->table[idx].state, from, kTombstone)) return false;
  finish_free(s, si, idx);
  return true;
}

// Run `fn(si, idx)` under the owning stripe's lock for the live entry
// matching id. The lock-free find is only a hint: a hit is re-verified
// under the lock, and a miss is confirmed by locked probes — a lock-free
// probe racing tombstone compaction must never make a mutation (release,
// delete, abort, get-pin) silently no-op, or pins leak and objects turn
// unevictable. Returns fn's result, or -ENOENT if the id is truly absent.
template <typename F>
int64_t with_entry_locked(Store* s, const uint8_t* id, F&& fn) {
  uint64_t h = hash_id(id);
  uint32_t home = stripe_of(s, h);
  for (int attempt = 0; attempt < 4; ++attempt) {
    uint32_t idx = find_lockfree(s, id, h, home);
    if (idx == kNil) break;
    uint32_t si = segment_of(s, idx);
    StripeGuard g(s, si);
    Entry* e = &s->table[idx];
    uint32_t st = ld32(&e->state);
    if ((st != kCreated && st != kSealed) || memcmp(e->id, id, kIdLen) != 0)
      continue;  // entry was freed/reused between probe and lock — retry
    return fn(si, idx);
  }
  // locked confirmation: probe each candidate segment under its lock
  uint32_t n = s->hdr->num_stripes;
  uint32_t scan = ld64(&s->hdr->fallback_count, __ATOMIC_RELAXED) ? n : 1;
  for (uint32_t k = 0; k < scan; ++k) {
    uint32_t si = (home + k) % n;
    StripeGuard g(s, si);
    uint32_t idx = probe_segment(s, si, id, h);
    if (idx != kNil) return fn(si, idx);
  }
  return -ENOENT;
}

// Evict lowest-seq sealed+unpinned+evictable objects from ONE stripe until
// `bytes` are reclaimable. Caller holds the stripe lock. Returns bytes
// freed. Only this stripe's clients can contend with the sweep.
// Evictable means droppable: a secondary copy pulled from another node,
// or a copy of an object that is already on disk. A primary copy is
// created with flags bit1 (not-evictable) and leaves the arena only by
// the node manager's spill, never here (Ray's rule: a primary stays
// pinned until it has been spilled).
uint64_t evict_stripe_locked(Store* s, uint32_t si, uint64_t bytes) {
  Stripe* sp = &s->hdr->stripes[si];
  if (sp->span_owner) return 0;  // span stripes have no per-entry LRU: a
                                 // span is reclaimed whole or not at all
  std::vector<std::pair<uint64_t, uint32_t>> cands;  // (seq, idx)
  for (uint32_t i = sp->seg_start; i < sp->seg_start + sp->seg_len; ++i) {
    Entry* e = &s->table[i];
    if (ld32(&e->state, __ATOMIC_RELAXED) == kSealed &&
        ld32(&e->pin_count, __ATOMIC_RELAXED) == 0 && !(e->flags & 2))
      cands.emplace_back(ld64(&e->seq, __ATOMIC_RELAXED), i);
  }
  std::sort(cands.begin(), cands.end());
  uint64_t freed = 0;
  for (auto& c : cands) {
    if (freed >= bytes) break;
    Entry* e = &s->table[c.second];
    uint64_t sz = e->data_size + e->meta_size;
    if (!entry_free_from(s, si, c.second, kSealed)) continue;
    sp->num_evictions++;
    sp->bytes_evicted += sz;
    freed += sz;
  }
  return freed;
}

// -------------------------------------------------------- chaos injection
// Deterministic crash hook for the robust-mutex recovery tests (the shm
// analog of rpc.py's RAY_TPU_TORCH_TESTING_RPC_FAILURE): spec
// RAY_TPU_TORCH_TESTING_SHM_FAILURE="shm_create=N" SIGKILLs this process inside
// its Nth rt_create WHILE HOLDING the stripe mutex mid-mutation — the
// worst-case death a survivor must repair from.
long chaos_crash_create_after() {
  static long n = [] {
    const char* raw = getenv("RAY_TPU_TORCH_TESTING_SHM_FAILURE");
    if (!raw) return 0L;
    const char* p = strstr(raw, "shm_create=");
    return p ? atol(p + sizeof("shm_create=") - 1) : 0L;
  }();
  return n;
}

void chaos_maybe_crash_in_create() {
  long after = chaos_crash_create_after();
  if (after <= 0) return;
  static std::atomic<long> creates{0};
  if (creates.fetch_add(1) + 1 == after) kill(getpid(), SIGKILL);
}

// Span analog: spec "shm_span_create=N" SIGKILLs this process inside its
// Nth spanning create AFTER at least one member stripe is claimed, while
// holding BOTH the span mutex and that stripe's mutex — the worst-case
// death the two-level repair (stripe EOWNERDEAD -> span broken; span
// EOWNERDEAD -> claiming slots freed) must recover from.
long chaos_crash_span_create_after() {
  static long n = [] {
    const char* raw = getenv("RAY_TPU_TORCH_TESTING_SHM_FAILURE");
    if (!raw) return 0L;
    const char* p = strstr(raw, "shm_span_create=");
    return p ? atol(p + sizeof("shm_span_create=") - 1) : 0L;
  }();
  return n;
}

void chaos_maybe_crash_in_span_create() {
  long after = chaos_crash_span_create_after();
  if (after <= 0) return;
  static std::atomic<long> creates{0};
  if (creates.fetch_add(1) + 1 == after) kill(getpid(), SIGKILL);
}

// ------------------------------------------------- spanning allocation
// All span-table mutations run under the header's robust span mutex.
// Lock order is span_mutex -> stripe mutex (one stripe at a time);
// nothing takes the span mutex while holding a stripe mutex (stripe
// crash repair only CASes span state lock-free), so the order is
// deadlock-free.

void span_free_locked(Store* s, uint32_t slot);

class SpanGuard {
 public:
  explicit SpanGuard(Store* s) : s_(s) {
    Header* h = s->hdr;
    int rc = pthread_mutex_lock(&h->span_mutex);
    bool dead = rc == EOWNERDEAD;
    if (dead) pthread_mutex_consistent(&h->span_mutex);
    bool need_repair = dead && ld32(&h->span_mutating);
    st32(&h->span_mutating, 1);
    if (dead && !need_repair) {
      // holder died between lock and the mutating publish (or after
      // clearing it): the table itself is consistent, but a claim may
      // still be stranded — the sweep below is idempotent, run it too
      need_repair = true;
    }
    if (need_repair) {
      // a span-mutex holder died: any kSpanClaiming slot belongs to it
      // (live claims hold the mutex end-to-end), and kSpanBroken slots
      // are ownerless — free both, reclaiming ALL member stripes, so
      // repair of a poisoned span is deterministic and whole-span.
      for (uint32_t k = 0; k < kMaxSpans; ++k) {
        uint32_t st = ld32(&h->spans[k].state);
        if (st == kSpanClaiming || st == kSpanBroken) {
          span_free_locked(s, k);
          add64(&h->span_repairs, 1, __ATOMIC_RELAXED);
        }
      }
    }
  }
  ~SpanGuard() {
    st32(&s_->hdr->span_mutating, 0);
    pthread_mutex_unlock(&s_->hdr->span_mutex);
  }

 private:
  Store* s_;
};

// Lock-free span lookup: slot index of a live (claiming excluded) span
// matching id, or -1. Publication via the release-store of state.
int span_find(Store* s, const uint8_t* id) {
  for (uint32_t k = 0; k < kMaxSpans; ++k) {
    SpanDesc* d = &s->hdr->spans[k];
    uint32_t st = ld32(&d->state);
    if ((st == kSpanCreated || st == kSpanSealed) &&
        memcmp(d->id, id, kIdLen) == 0)
      return (int)k;
  }
  return -1;
}

// Free one span: unpublish the descriptor, then release every member
// stripe (identified by span_owner, NOT the descriptor's range — a
// crash mid-claim leaves the range unreliable but span_owner exact),
// rebuilding each heap to fresh-store state. Caller holds the span
// mutex. Idempotent: a stripe already reclaimed by its own crash
// repair (span_owner cleared) is skipped.
void span_free_locked(Store* s, uint32_t slot) {
  Header* h = s->hdr;
  SpanDesc* d = &h->spans[slot];
  st32(&d->state, kSpanBroken);  // unpublish before the stripes die
  for (uint32_t si = 0; si < h->num_stripes; ++si) {
    if (ld32(&h->stripes[si].span_owner, __ATOMIC_RELAXED) != slot + 1)
      continue;
    StripeGuard g(s, si);
    Stripe* sp = &h->stripes[si];
    if (sp->span_owner != slot + 1) continue;  // reclaimed under us
    sp->span_owner = 0;
    reset_stripe_heap_locked(s, sp);
  }
  memset(d->id, 0, kIdLen);
  d->data_size = d->meta_size = 0;
  d->pin_count = 0;
  d->flags = 0;
  st32(&d->state, kSpanEmpty);
}

// A normal create met a span-owned stripe: if the owning span is dead
// (broken/empty — e.g. a crashed claim whose repair ran elsewhere),
// reclaim the stripe for normal allocation. Caller holds the stripe
// mutex (racing span_free_locked serializes on it; both sides re-check
// span_owner under the lock, so the reclaim happens exactly once).
// Returns true when the stripe is usable for normal allocation.
bool reclaim_dead_span_stripe_locked(Store* s, uint32_t si) {
  Stripe* sp = &s->hdr->stripes[si];
  uint32_t slot = sp->span_owner - 1;
  uint32_t st = slot < kMaxSpans
                    ? ld32(&s->hdr->spans[slot].state)
                    : (uint32_t)kSpanEmpty;  // corrupt owner: reclaim
  if (st != kSpanEmpty && st != kSpanBroken) return false;
  sp->span_owner = 0;
  reset_stripe_heap_locked(s, sp);
  return true;
}

// Evict whole LRU spans (sealed + unpinned + evictable) until `bytes`
// are freed; broken slots are reclaimed for free. Returns bytes freed.
uint64_t span_evict_bytes(Store* s, uint64_t bytes) {
  Header* h = s->hdr;
  SpanGuard g(s);
  uint64_t freed = 0;
  for (uint32_t k = 0; k < kMaxSpans; ++k)
    if (ld32(&h->spans[k].state) == kSpanBroken) span_free_locked(s, k);
  for (;;) {
    if (freed >= bytes) break;
    int victim = -1;
    uint64_t best_seq = ~0ULL;
    for (uint32_t k = 0; k < kMaxSpans; ++k) {
      SpanDesc* d = &h->spans[k];
      if (ld32(&d->state) != kSpanSealed || d->pin_count > 0 ||
          (d->flags & 2))
        continue;
      if (d->seq < best_seq) { best_seq = d->seq; victim = (int)k; }
    }
    if (victim < 0) break;
    uint64_t sz = h->spans[victim].data_size + h->spans[victim].meta_size;
    span_free_locked(s, (uint32_t)victim);
    add64(&h->span_evictions, 1, __ATOMIC_RELAXED);
    freed += sz;
  }
  return freed;
}

// Create a spanning object across `m` contiguous whole stripes. Caller
// guarantees need > 0. Returns the base-relative payload offset or a
// negative errno-style code (same contract as rt_create).
int64_t span_create(Store* s, const uint8_t* id, uint64_t data_size,
                    uint64_t meta_size, int evictable) {
  Header* h = s->hdr;
  uint64_t need = data_size + meta_size;
  uint64_t stripe_sz = h->stripes[0].arena_size;
  uint32_t m = (uint32_t)((need + stripe_sz - 1) / stripe_sz);
  if (m == 0) m = 1;
  if (m > h->num_stripes) return -ENOMEM;

  SpanGuard g(s);
  if (span_find(s, id) >= 0) return -EEXIST;
  {  // best-effort dup check against the normal table (same contract as
     // rt_create's lock-free re-home check)
    uint64_t hsh = hash_id(id);
    if (find_lockfree(s, id, hsh, stripe_of(s, hsh)) != kNil)
      return -EEXIST;
  }
  int slot = -1;
  for (int pass = 0; pass < 2 && slot < 0; ++pass) {
    for (uint32_t k = 0; k < kMaxSpans; ++k) {
      uint32_t st = ld32(&h->spans[k].state);
      if (st == kSpanEmpty) { slot = (int)k; break; }
      if (pass && st == kSpanBroken) {  // gc a dead slot and take it
        span_free_locked(s, k);
        slot = (int)k;
        break;
      }
    }
  }
  if (slot < 0) return -ENFILE;

  SpanDesc* d = &h->spans[slot];
  memcpy(d->id, id, kIdLen);
  d->data_size = data_size;
  d->meta_size = meta_size;
  d->pin_count = 0;
  d->flags = evictable ? 0 : 2;
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  d->ctime_sec = (uint64_t)ts.tv_sec;
  // publish CLAIMING before touching any stripe: if we die mid-claim,
  // the span-mutex repair frees exactly this slot's claimed stripes
  st32(&d->state, kSpanClaiming);

  // Two passes over the candidate windows: first claim only windows
  // whose residents LRU-evict cleanly; pinned/unsealed residents fail
  // the window and the claim slides on. (The caller's spill+retry is
  // the pressure valve when every window is blocked.)
  for (uint32_t start = 0; start + m <= h->num_stripes; ++start) {
    uint32_t claimed = 0;
    for (; claimed < m; ++claimed) {
      uint32_t si = start + claimed;
      StripeGuard sg(s, si);
      Stripe* sp = &h->stripes[si];
      if (sp->span_owner && !reclaim_dead_span_stripe_locked(s, si)) break;
      if (sp->bytes_in_use) evict_stripe_locked(s, si, sp->arena_size);
      if (sp->bytes_in_use || sp->num_objects) break;
      sp->span_owner = (uint32_t)slot + 1;
      // claimed stripes read as fully used: stats, spill-pressure
      // probes and sweep targeting all see the span's footprint
      sp->bytes_in_use = sp->arena_size;
      // chaos hook: die HERE — span mutex + this stripe's mutex held,
      // descriptor CLAIMING, stripe marked but span unpublished
      chaos_maybe_crash_in_span_create();
    }
    if (claimed == m) {
      d->first_stripe = start;
      d->n_stripes = m;
      d->seq = ++h->span_clock;
      st32(&d->state, kSpanCreated);  // release: publishes the span
      add64(&h->span_creates, 1, __ATOMIC_RELAXED);
      return (int64_t)h->stripes[start].arena_off;
    }
    // window failed: unwind this window's claims
    for (uint32_t u = 0; u < claimed; ++u) {
      StripeGuard sg(s, start + u);
      Stripe* sp = &h->stripes[start + u];
      if (sp->span_owner == (uint32_t)slot + 1) {
        sp->span_owner = 0;
        reset_stripe_heap_locked(s, sp);
      }
    }
  }
  memset(d->id, 0, kIdLen);
  st32(&d->state, kSpanEmpty);
  return -ENOMEM;
}

// ------------------------------------------------------------ copy pool
// Chunked arena copies for the put hot path: the Python binding (ctypes)
// drops the GIL for the duration of the call, and the pool spreads large
// memcpys across a few threads. Per-call latency on a 1-core host is the
// memcpy itself (nthreads<=1 short-circuits to a plain memcpy, no pool
// wakeup); wider hosts split the copy into near-equal 64B-aligned chunks.
struct CopyBatch {
  std::mutex mu;
  std::condition_variable cv;
  int remaining = 0;
};

struct CopyChunk {
  uint8_t* dst;
  const uint8_t* src;
  uint64_t n;
  CopyBatch* batch;
};

class CopyPool {
 public:
  static CopyPool& Instance() {
    static CopyPool* pool = new CopyPool();  // never destroyed: workers may
    return *pool;                            // outlive static teardown order
  }

  // Copy n bytes dst<-src split across `nchunks` pieces; the calling
  // thread copies the first chunk itself, pool threads do the rest.
  void Run(uint8_t* dst, const uint8_t* src, uint64_t n, int nchunks) {
    if (nchunks > kMaxThreads) nchunks = kMaxThreads;
    // 64B-aligned chunk size so no two threads share a cache line
    uint64_t chunk = (n / nchunks + 63) & ~63ULL;
    int pieces = (int)((n + chunk - 1) / chunk);
    if (pieces <= 1) {
      memcpy(dst, src, n);
      return;
    }
    EnsureThreads(pieces - 1);
    CopyBatch batch;
    batch.remaining = pieces - 1;
    {
      std::lock_guard<std::mutex> g(mu_);
      for (int i = 1; i < pieces; i++) {
        uint64_t off = (uint64_t)i * chunk;
        uint64_t len = off + chunk <= n ? chunk : n - off;
        q_.push_back({dst + off, src + off, len, &batch});
      }
    }
    cv_.notify_all();
    memcpy(dst, src, chunk);  // caller's share overlaps the workers
    std::unique_lock<std::mutex> g(batch.mu);
    batch.cv.wait(g, [&] { return batch.remaining == 0; });
  }

 private:
  static constexpr int kMaxThreads = 16;

  void EnsureThreads(int want) {
    std::lock_guard<std::mutex> g(mu_);
    while ((int)threads_.size() < want && (int)threads_.size() < kMaxThreads)
      threads_.emplace_back([this] { WorkerLoop(); });
  }

  void WorkerLoop() {
    for (;;) {
      CopyChunk c;
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait(g, [this] { return !q_.empty(); });
        c = q_.front();
        q_.pop_front();
      }
      memcpy(c.dst, c.src, c.n);
      {
        // notify while holding the lock: the batch lives on the caller's
        // stack and is destroyed the moment Run() observes remaining==0,
        // so the cv must not be touched after this block releases mu
        std::lock_guard<std::mutex> g(c.batch->mu);
        c.batch->remaining--;
        c.batch->cv.notify_one();
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<CopyChunk> q_;
  std::vector<std::thread> threads_;
};

// How many stripes a new store gets. Explicit request wins; otherwise the
// RAY_TPU_TORCH_ARENA_STRIPES env var; otherwise size/kMinStripeBytes capped at
// 8 — so small test arenas stay single-stripe (exactly the v1 behavior)
// and production-sized arenas stripe wide enough for node-local clients.
uint32_t resolve_stripes(uint64_t arena_size, int requested) {
  long n = requested;
  if (n <= 0) {
    const char* env = getenv("RAY_TPU_TORCH_ARENA_STRIPES");
    n = env ? atol(env) : 0;
    if (n <= 0) {
      n = (long)(arena_size / kMinStripeBytes);
      if (n > 8) n = 8;
    }
  }
  if (n < 1) n = 1;
  if (n > (long)kMaxStripes) n = (long)kMaxStripes;
  // hard floor: a stripe smaller than 1 MiB cannot hold real objects
  while (n > 1 && arena_size / (uint64_t)n < (1ULL << 20)) n--;
  return (uint32_t)n;
}

struct StripeSnap {
  uint64_t bytes_in_use, capacity, num_objects, num_evictions,
      bytes_evicted, create_count, get_hits, get_misses, repairs,
      seal_count, poisoned;
};

void read_stripe_fields(Stripe* sp, StripeSnap* o) {
  o->bytes_in_use = ld64(&sp->bytes_in_use, __ATOMIC_RELAXED);
  o->capacity = sp->arena_size;
  o->num_objects = ld64(&sp->num_objects, __ATOMIC_RELAXED);
  o->num_evictions = ld64(&sp->num_evictions, __ATOMIC_RELAXED);
  o->bytes_evicted = ld64(&sp->bytes_evicted, __ATOMIC_RELAXED);
  o->create_count = ld64(&sp->create_count, __ATOMIC_RELAXED);
  o->get_hits = ld64(&sp->get_hits, __ATOMIC_RELAXED);
  o->get_misses = ld64(&sp->get_misses, __ATOMIC_RELAXED);
  o->repairs = ld64(&sp->repairs, __ATOMIC_RELAXED);
  o->seal_count = ld64(&sp->seal_count, __ATOMIC_RELAXED);
  o->poisoned = ld32(&sp->poisoned, __ATOMIC_RELAXED);
}

// Seqlock read of one stripe's counters; never blocks on a healthy store.
// Falls back to the mutex only when a writer looks stuck — which is
// exactly the robust-recovery probe needed if that writer is dead.
void snapshot_stripe(Store* s, uint32_t si, StripeSnap* o) {
  Stripe* sp = &s->hdr->stripes[si];
  for (int spin = 0; spin < 4096; ++spin) {
    uint64_t s0 = ld64(&sp->lockseq);
    if (s0 & 1) continue;
    read_stripe_fields(sp, o);
    __atomic_thread_fence(__ATOMIC_ACQUIRE);
    if (ld64(&sp->lockseq) == s0) {
      // validated: pair with the writer's RT_TSAN_RELEASE in
      // ~StripeGuard — the snapshot happens-after the last closed window
      RT_TSAN_ACQUIRE(&sp->lockseq);
      return;
    }
  }
  StripeGuard g(s, si);
  read_stripe_fields(sp, o);
}

}  // namespace

extern "C" {

// Chunked (optionally multi-threaded) memcpy into the arena. Called via
// ctypes, which releases the GIL for the duration — large put copies no
// longer serialize every Python thread in the process. threads<=1 (or a
// copy too small to split) is a plain memcpy on the calling thread.
void rt_write_parallel(void* dst, const void* src, uint64_t n, int threads) {
  if (n == 0) return;
  if (threads <= 1 || n < (1u << 20)) {
    memcpy(dst, src, n);
    return;
  }
  CopyPool::Instance().Run(static_cast<uint8_t*>(dst),
                           static_cast<const uint8_t*>(src), n, threads);
}

// Create a fresh store. `stripes` <= 0 resolves via RAY_TPU_TORCH_ARENA_STRIPES
// then size-based auto-striping.
void* rt_store_create(const char* path, uint64_t size, int stripes) {
  // Always create a fresh inode (O_EXCL after unlink): truncating an
  // existing path would SIGBUS any process still mapping the old store.
  unlink(path);
  int fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd < 0) return nullptr;
  uint64_t table_bytes = align_up(sizeof(Entry) * (uint64_t)kTableCapacity, 4096);
  uint64_t header_bytes = align_up(sizeof(Header), 4096);
  uint64_t total = align_up(header_bytes + table_bytes + size, 4096);
  if (ftruncate(fd, (off_t)total) != 0) { close(fd); return nullptr; }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { close(fd); return nullptr; }
  // Hugepage-advise the arena: first-touch fault cost dominates large-object
  // writes on virtualized hosts (measured 30x on 4K faults); THP cuts the
  // fault count ~512x.
  madvise(mem, total, MADV_HUGEPAGE);

  Store* s = new Store();
  s->base = static_cast<uint8_t*>(mem);
  s->hdr = reinterpret_cast<Header*>(mem);
  s->table = reinterpret_cast<Entry*>(s->base + header_bytes);
  s->map_size = total;
  s->fd = fd;

  Header* h = s->hdr;
  memset(h, 0, sizeof(Header));
  memset(s->table, 0, sizeof(Entry) * (uint64_t)kTableCapacity);
  h->version = kVersion;
  h->table_capacity = kTableCapacity;
  h->total_size = total;
  h->arena_offset = header_bytes + table_bytes;
  h->arena_size = total - h->arena_offset;
  h->num_stripes = resolve_stripes(h->arena_size, stripes);

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);

  pthread_mutex_init(&h->span_mutex, &attr);

  uint64_t stripe_sz = (h->arena_size / h->num_stripes) & ~(kAlign - 1);
  uint32_t seg_len = kTableCapacity / h->num_stripes;
  for (uint32_t i = 0; i < h->num_stripes; ++i) {
    Stripe* sp = &h->stripes[i];
    pthread_mutex_init(&sp->mutex, &attr);
    sp->arena_off = h->arena_offset + (uint64_t)i * stripe_sz;
    sp->arena_size = stripe_sz;
    sp->seg_start = i * seg_len;
    sp->seg_len = seg_len;
    sp->free_head = kNone;
    Block* b = at(s, sp, 0);
    set_size(b, sp->arena_size, true);
    b->prev_size = 0;
    b->next_free = kNone;
    b->prev_free = kNone;
    sp->free_head = 0;
  }
  pthread_mutexattr_destroy(&attr);

  std::atomic_thread_fence(std::memory_order_seq_cst);
  h->magic = kMagic;  // publish last
  return s;
}

void* rt_store_open(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { close(fd); return nullptr; }
  madvise(mem, (size_t)st.st_size, MADV_HUGEPAGE);
  Header* h = reinterpret_cast<Header*>(mem);
  if (h->magic != kMagic || h->version != kVersion) {
    munmap(mem, (size_t)st.st_size);
    close(fd);
    return nullptr;
  }
  Store* s = new Store();
  s->base = static_cast<uint8_t*>(mem);
  s->hdr = h;
  uint64_t header_bytes = align_up(sizeof(Header), 4096);
  s->table = reinterpret_cast<Entry*>(s->base + header_bytes);
  s->map_size = h->total_size;
  s->fd = fd;
  return s;
}

void rt_store_close(void* hs) {
  Store* s = static_cast<Store*>(hs);
  munmap(s->base, s->map_size);
  close(s->fd);
  delete s;
}

uint8_t* rt_store_base(void* hs) { return static_cast<Store*>(hs)->base; }

uint32_t rt_num_stripes(void* hs) {
  return static_cast<Store*>(hs)->hdr->num_stripes;
}

uint64_t rt_store_capacity(void* hs) {
  // usable capacity = sum of stripe slices (alignment slack excluded)
  Store* s = static_cast<Store*>(hs);
  return (uint64_t)s->hdr->num_stripes * s->hdr->stripes[0].arena_size;
}

uint64_t rt_store_total_size(void* hs) { return static_cast<Store*>(hs)->hdr->total_size; }

// Create an object buffer. Returns base-relative offset of the payload
// (data followed by metadata), or a negative errno-style code:
//   -EEXIST already exists, -ENOMEM no space even after per-stripe
//   eviction, -ENFILE table full.
//
// Lock discipline: the fast path (home stripe has room) takes exactly one
// stripe lock. Under pressure the create walks the other stripes
// round-robin — sequentially, never holding two locks at once — first
// without eviction, then with per-stripe eviction as a last resort (the
// node manager's sweep keeps stripes below watermark so this stays rare).
int64_t rt_create(void* hs, const uint8_t* id, uint64_t data_size,
                  uint64_t meta_size, int evictable) {
  Store* s = static_cast<Store*>(hs);
  uint64_t need = data_size + meta_size;
  uint64_t h = hash_id(id);
  uint32_t nstripes = s->hdr->num_stripes;
  uint32_t home = stripe_of(s, h);

  // size-aware route: an object no single stripe can hold takes the
  // spanning path (contiguous whole stripes) — the Python client and
  // every transfer path gain multi-GB objects with no API change
  if (align_up(need + kBlockHeader, kAlign) > s->hdr->stripes[0].arena_size)
    return span_create(s, id, data_size, meta_size, evictable);
  if (span_find(s, id) >= 0) return -EEXIST;

  // duplicate check for re-homed objects: best-effort lock-free (exact
  // within the home stripe below; a concurrent same-id double-create is
  // caller misuse and at worst wastes one block until delete)
  if (ld64(&s->hdr->fallback_count, __ATOMIC_RELAXED) != 0 &&
      find_lockfree(s, id, h, home) != kNil)
    return -EEXIST;

  int64_t soft_rc = -ENOMEM;
  // pass 0: no evict; 1: per-stripe LRU evict; 2: only reached when
  // whole-span eviction freed stripes back to the normal allocator
  for (int pass = 0; pass < 3; ++pass) {
    if (pass == 2 && span_evict_bytes(s, need) == 0) break;
    for (uint32_t k = 0; k < nstripes; ++k) {
      uint32_t si = (home + k) % nstripes;
      Stripe* sp = &s->hdr->stripes[si];
      StripeGuard g(s, si);
      if (sp->span_owner && !reclaim_dead_span_stripe_locked(s, si))
        continue;  // the stripe belongs to a live spanning object
      if (probe_segment(s, si, id, h) != kNil) return -EEXIST;
      uint32_t slot = segment_slot(s, si, h);
      if (slot == kNil) { soft_rc = -ENFILE; continue; }
      uint64_t off = heap_alloc(s, sp, need);
      if (off == kNone && pass >= 1) {
        evict_stripe_locked(s, si, need);
        off = heap_alloc(s, sp, need);
      }
      if (off == kNone) continue;
      Entry* e = &s->table[slot];
      memcpy(e->id, id, kIdLen);
      // chaos hook: die HERE — lock held, heap mutated, entry half-written
      chaos_maybe_crash_in_create();
      e->stripe = si;
      e->offset = off;
      e->data_size = data_size;
      e->meta_size = meta_size;
      st32(&e->pin_count, 1, __ATOMIC_RELAXED);  // creator pin until seal
      e->flags = evictable ? 0 : 2;
      struct timespec ts;
      clock_gettime(CLOCK_MONOTONIC, &ts);
      e->ctime_sec = (uint64_t)ts.tv_sec;
      st64(&e->seq, add64(&sp->lru_clock, 1) + 1, __ATOMIC_RELAXED);
      st32(&e->state, kCreated);  // release: publishes the entry
      sp->num_objects++;
      sp->create_count++;
      if (si != home) add64(&s->hdr->fallback_count, 1);
      return (int64_t)(sp->arena_off + off);
    }
  }
  return soft_rc;
}

// Seal: lock-free CREATED -> SEALED transition. Takes no heap lock on the
// fast path; the locked fallback only runs when a concurrent tombstone
// compaction hid the entry from the lock-free probe (vanishingly rare).
int rt_seal(void* hs, const uint8_t* id) {
  Store* s = static_cast<Store*>(hs);
  uint64_t h = hash_id(id);
  uint32_t home = stripe_of(s, h);
  uint32_t idx = find_lockfree(s, id, h, home);
  if (idx == kNil && span_find(s, id) >= 0) {
    // spanning object: CREATED -> SEALED under the span mutex (the
    // lock cost is nothing next to the multi-GB payload copy)
    SpanGuard g(s);
    int k = span_find(s, id);
    if (k < 0) return -ENOENT;
    SpanDesc* d = &s->hdr->spans[k];
    d->seq = ++s->hdr->span_clock;
    if (!cas32(&d->state, kSpanCreated, kSpanSealed)) {
      uint32_t now = ld32(&d->state);
      return (now == kSpanSealed) ? -EINVAL : -ENOENT;
    }
    return 0;
  }
  if (idx == kNil) {
    // confirm the miss under the locks before failing
    uint32_t n = s->hdr->num_stripes;
    for (uint32_t k = 0; k < n && idx == kNil; ++k) {
      StripeGuard g(s, (home + k) % n);
      idx = probe_segment(s, (home + k) % n, id, h);
    }
    if (idx == kNil) return -ENOENT;
  }
  Entry* e = &s->table[idx];
  Stripe* sp = &s->hdr->stripes[segment_of(s, idx)];
  // Order matters: the creator pin must read 0 and the LRU stamp must be
  // set BEFORE the release-CAS publishes SEALED — a get() that observes
  // SEALED (acquire) then sees a consistent entry. Only the creator can
  // legally seal, so the entry cannot be freed+reused under us (gc only
  // reaps CREATED entries minutes old).
  st32(&e->pin_count, 0, __ATOMIC_RELAXED);
  st64(&e->seq, add64(&sp->lru_clock, 1) + 1, __ATOMIC_RELAXED);
  if (!cas32(&e->state, kCreated, kSealed)) {
    uint32_t now = ld32(&e->state);
    return (now == kEmpty || now == kTombstone) ? -ENOENT : -EINVAL;
  }
  add64(&sp->seal_count, 1, __ATOMIC_RELAXED);
  return 0;
}

// Look up a sealed object. On hit fills sizes, pins if pin!=0, returns
// base-relative payload offset. -ENOENT if absent or not sealed. Takes
// exactly one stripe lock on a hit; a miss confirms under the locks (a
// lock-free probe can race tombstone compaction).
int64_t rt_get(void* hs, const uint8_t* id, uint64_t* data_size,
               uint64_t* meta_size, int pin) {
  Store* s = static_cast<Store*>(hs);
  int64_t rc = with_entry_locked(s, id, [&](uint32_t si, uint32_t idx) {
    Stripe* sp = &s->hdr->stripes[si];
    Entry* e = &s->table[idx];
    if (ld32(&e->state) != kSealed) return (int64_t)-ENOENT;  // unsealed
    *data_size = e->data_size;
    *meta_size = e->meta_size;
    if (pin) st32(&e->pin_count, ld32(&e->pin_count) + 1, __ATOMIC_RELAXED);
    st64(&e->seq, add64(&sp->lru_clock, 1) + 1, __ATOMIC_RELAXED);
    sp->get_hits++;
    return (int64_t)(sp->arena_off + e->offset);
  });
  if (rc < 0 && span_find(s, id) >= 0) {
    SpanGuard g(s);
    int k = span_find(s, id);
    if (k >= 0 && ld32(&s->hdr->spans[k].state) == kSpanSealed) {
      SpanDesc* d = &s->hdr->spans[k];
      *data_size = d->data_size;
      *meta_size = d->meta_size;
      if (pin) d->pin_count++;
      d->seq = ++s->hdr->span_clock;
      // span hits attribute to the head stripe (atomic: no stripe lock)
      add64(&s->hdr->stripes[d->first_stripe].get_hits, 1,
            __ATOMIC_RELAXED);
      return (int64_t)s->hdr->stripes[d->first_stripe].arena_off;
    }
  }
  if (rc < 0) {
    uint32_t home = stripe_of(s, hash_id(id));
    add64(&s->hdr->stripes[home].get_misses, 1, __ATOMIC_RELAXED);
  }
  return rc;
}

int rt_release(void* hs, const uint8_t* id) {
  Store* s = static_cast<Store*>(hs);
  int rc = (int)with_entry_locked(s, id, [&](uint32_t si, uint32_t idx) {
    Entry* e = &s->table[idx];
    uint32_t st = ld32(&e->state);
    uint32_t pins = ld32(&e->pin_count, __ATOMIC_RELAXED);
    if (pins > 0) st32(&e->pin_count, pins - 1, __ATOMIC_RELAXED);
    if ((e->flags & 1) && pins <= 1) entry_free_from(s, si, idx, st);
    return (int64_t)0;
  });
  if (rc == -ENOENT && span_find(s, id) >= 0) {
    SpanGuard g(s);
    int k = span_find(s, id);
    if (k < 0) return -ENOENT;
    SpanDesc* d = &s->hdr->spans[k];
    if (d->pin_count > 0) d->pin_count--;
    if ((d->flags & 1) && d->pin_count == 0) span_free_locked(s, (uint32_t)k);
    return 0;
  }
  return rc;
}

int rt_contains(void* hs, const uint8_t* id) {
  Store* s = static_cast<Store*>(hs);
  {
    int k = span_find(s, id);
    if (k >= 0)
      return ld32(&s->hdr->spans[k].state) == kSpanSealed ? 1 : 0;
  }
  uint64_t h = hash_id(id);
  uint32_t home = stripe_of(s, h);
  uint32_t idx = find_lockfree(s, id, h, home);
  if (idx != kNil)
    return ld32(&s->table[idx].state) == kSealed &&
                   memcmp(s->table[idx].id, id, kIdLen) == 0
               ? 1
               : 0;
  // lock-free probes can race tombstone compaction: confirm the miss
  uint32_t n = s->hdr->num_stripes;
  uint32_t scan = ld64(&s->hdr->fallback_count, __ATOMIC_RELAXED) ? n : 1;
  for (uint32_t k = 0; k < scan; ++k) {
    uint32_t si = (home + k) % n;
    StripeGuard g(s, si);
    idx = probe_segment(s, si, id, h);
    if (idx != kNil) return ld32(&s->table[idx].state) == kSealed ? 1 : 0;
  }
  return 0;
}

// Mark an object droppable (evictable != 0) or not. The node manager
// creates a copy restored from disk not-evictable, so that no create
// evicts it before its reader has read it, and marks it droppable once
// that grace has passed. -ENOENT if absent.
int rt_set_evictable(void* hs, const uint8_t* id, int evictable) {
  Store* s = static_cast<Store*>(hs);
  if (span_find(s, id) >= 0) {
    SpanGuard g(s);
    int k = span_find(s, id);
    if (k >= 0) {
      SpanDesc* d = &s->hdr->spans[k];
      d->flags = evictable ? (d->flags & ~2u) : (d->flags | 2u);
      return 0;
    }
  }
  return (int)with_entry_locked(s, id, [&](uint32_t, uint32_t idx) {
    Entry* e = &s->table[idx];
    e->flags = evictable ? (e->flags & ~2u) : (e->flags | 2u);
    return (int64_t)0;
  });
}

// Delete (deferred if pinned). -ENOENT if absent.
int rt_delete(void* hs, const uint8_t* id) {
  Store* s = static_cast<Store*>(hs);
  if (span_find(s, id) >= 0) {
    SpanGuard g(s);
    int k = span_find(s, id);
    if (k >= 0) {
      SpanDesc* d = &s->hdr->spans[k];
      if (d->pin_count > 0)
        d->flags |= 1;  // delete-pending; release completes it
      else
        span_free_locked(s, (uint32_t)k);
      return 0;
    }
  }
  return (int)with_entry_locked(s, id, [&](uint32_t si, uint32_t idx) {
    Entry* e = &s->table[idx];
    uint32_t st = ld32(&e->state);
    if (ld32(&e->pin_count, __ATOMIC_RELAXED) > 0) {
      e->flags |= 1;  // delete-pending
      return (int64_t)0;
    }
    if (entry_free_from(s, si, idx, st)) return (int64_t)0;
    // a lock-free seal raced the CAS: retry from the (now SEALED) state
    if (entry_free_from(s, si, idx, kSealed)) return (int64_t)0;
    return (int64_t)-ENOENT;
  });
}

// Abort an in-progress creation (writer failed before seal).
int rt_abort(void* hs, const uint8_t* id) {
  Store* s = static_cast<Store*>(hs);
  if (span_find(s, id) >= 0) {
    SpanGuard g(s);
    int k = span_find(s, id);
    if (k >= 0) {
      if (ld32(&s->hdr->spans[k].state) != kSpanCreated) return -EINVAL;
      span_free_locked(s, (uint32_t)k);
      return 0;
    }
  }
  return (int)with_entry_locked(s, id, [&](uint32_t si, uint32_t idx) {
    if (ld32(&s->table[idx].state) != kCreated) return (int64_t)-EINVAL;
    return entry_free_from(s, si, idx, kCreated) ? (int64_t)0
                                                 : (int64_t)-EINVAL;
  });
}

// Reclaim CREATED-but-never-sealed objects older than max_age_sec — their
// writer likely died before sealing. Returns number reclaimed. Called
// periodically by the node daemon's sweep.
uint64_t rt_gc_unsealed(void* hs, uint64_t max_age_sec) {
  Store* s = static_cast<Store*>(hs);
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  uint64_t now = (uint64_t)ts.tv_sec;
  uint64_t n = 0;
  for (uint32_t si = 0; si < s->hdr->num_stripes; ++si) {
    Stripe* sp = &s->hdr->stripes[si];
    StripeGuard g(s, si);
    for (uint32_t i = sp->seg_start; i < sp->seg_start + sp->seg_len; ++i) {
      Entry* e = &s->table[i];
      if (ld32(&e->state, __ATOMIC_RELAXED) == kCreated &&
          now - e->ctime_sec >= max_age_sec &&
          entry_free_from(s, si, i, kCreated))  // CAS guards racing seals
        ++n;
    }
  }
  {
    // span pass: broken spans reclaim unconditionally (deterministic
    // cleanup after a crash repair marked them); CREATED-but-unsealed
    // spans age out exactly like entries. kSpanClaiming slots can only
    // belong to a dead writer once we hold the span mutex — free them.
    SpanGuard g(s);
    for (uint32_t k = 0; k < kMaxSpans; ++k) {
      SpanDesc* d = &s->hdr->spans[k];
      uint32_t st = ld32(&d->state);
      if (st == kSpanBroken || st == kSpanClaiming ||
          (st == kSpanCreated && now - d->ctime_sec >= max_age_sec)) {
        span_free_locked(s, k);
        ++n;
      }
    }
  }
  return n;
}

// Evict up to `bytes` from one stripe (node-manager sweep entry point).
uint64_t rt_evict_stripe(void* hs, uint32_t stripe, uint64_t bytes) {
  Store* s = static_cast<Store*>(hs);
  if (stripe >= s->hdr->num_stripes) return 0;
  StripeGuard g(s, stripe);
  return evict_stripe_locked(s, stripe, bytes);
}

uint64_t rt_evict(void* hs, uint64_t bytes) {
  Store* s = static_cast<Store*>(hs);
  uint64_t freed = 0;
  for (uint32_t si = 0; si < s->hdr->num_stripes && freed < bytes; ++si) {
    StripeGuard g(s, si);
    freed += evict_stripe_locked(s, si, bytes - freed);
  }
  if (freed < bytes)
    freed += span_evict_bytes(s, bytes - freed);  // whole spans, never half
  return freed;
}

// Aggregate store stats, served lock-free from per-stripe seqlock
// snapshots — a stats poll never queues behind a client's create.
// out[17]: bytes_in_use, capacity, num_objects, num_evictions,
// bytes_evicted, create_count, get_hits, get_misses, poisoned,
// num_stripes, stripe_repairs, create_fallbacks, seal_count,
// num_spans, span_creates, span_evictions, span_repairs.
void rt_stats(void* hs, uint64_t* out) {
  Store* s = static_cast<Store*>(hs);
  memset(out, 0, 17 * sizeof(uint64_t));
  for (uint32_t si = 0; si < s->hdr->num_stripes; ++si) {
    StripeSnap sn;
    snapshot_stripe(s, si, &sn);
    out[0] += sn.bytes_in_use;
    out[1] += sn.capacity;
    out[2] += sn.num_objects;
    out[3] += sn.num_evictions;
    out[4] += sn.bytes_evicted;
    out[5] += sn.create_count;
    out[6] += sn.get_hits;
    out[7] += sn.get_misses;
    out[8] += sn.poisoned;
    out[10] += sn.repairs;
    out[12] += sn.seal_count;
  }
  out[9] = s->hdr->num_stripes;
  out[11] = ld64(&s->hdr->fallback_count, __ATOMIC_RELAXED);
  for (uint32_t k = 0; k < kMaxSpans; ++k) {
    uint32_t st = ld32(&s->hdr->spans[k].state);
    if (st == kSpanCreated || st == kSpanSealed) {
      out[13]++;   // live spans
      out[2]++;    // a span is a live object too
    }
  }
  out[14] = ld64(&s->hdr->span_creates, __ATOMIC_RELAXED);
  out[15] = ld64(&s->hdr->span_evictions, __ATOMIC_RELAXED);
  out[16] = ld64(&s->hdr->span_repairs, __ATOMIC_RELAXED);
}

// Per-stripe stats (lock-free snapshot) for sweep targeting and bench
// attribution. out[8]: bytes_in_use, capacity, num_objects,
// num_evictions, bytes_evicted, repairs, poisoned, seal_count.
void rt_stripe_stats(void* hs, uint32_t stripe, uint64_t* out) {
  Store* s = static_cast<Store*>(hs);
  memset(out, 0, 8 * sizeof(uint64_t));
  if (stripe >= s->hdr->num_stripes) return;
  StripeSnap sn;
  snapshot_stripe(s, stripe, &sn);
  out[0] = sn.bytes_in_use;
  out[1] = sn.capacity;
  out[2] = sn.num_objects;
  out[3] = sn.num_evictions;
  out[4] = sn.bytes_evicted;
  out[5] = sn.repairs;
  out[6] = sn.poisoned;
  out[7] = sn.seal_count;
}

// List up to max_n sealed object ids of ONE stripe into out.
uint64_t rt_list_stripe(void* hs, uint32_t stripe, uint8_t* out,
                        uint64_t max_n) {
  Store* s = static_cast<Store*>(hs);
  if (stripe >= s->hdr->num_stripes) return 0;
  Stripe* sp = &s->hdr->stripes[stripe];
  StripeGuard g(s, stripe);
  uint64_t n = 0;
  for (uint32_t i = sp->seg_start; i < sp->seg_start + sp->seg_len && n < max_n;
       ++i) {
    Entry* e = &s->table[i];
    if (ld32(&e->state, __ATOMIC_RELAXED) == kSealed) {
      memcpy(out + n * kIdLen, e->id, kIdLen);
      ++n;
    }
  }
  return n;
}

// List up to max_n sealed object ids into out (max_n * kIdLen bytes).
// Locks stripes one at a time — never the whole store. Sealed spanning
// objects are appended after the per-stripe listings.
uint64_t rt_list(void* hs, uint8_t* out, uint64_t max_n) {
  Store* s = static_cast<Store*>(hs);
  uint64_t n = 0;
  for (uint32_t si = 0; si < s->hdr->num_stripes && n < max_n; ++si)
    n += rt_list_stripe(hs, si, out + n * kIdLen, max_n - n);
  for (uint32_t k = 0; k < kMaxSpans && n < max_n; ++k) {
    SpanDesc* d = &s->hdr->spans[k];
    if (ld32(&d->state) == kSpanSealed) {
      memcpy(out + n * kIdLen, d->id, kIdLen);
      ++n;
    }
  }
  return n;
}

// -------------------------------------------------- observability ABI
// Read-only widening for the object-lifetime ledger and the memory
// observability surface (`ray_tpu_torch memory`): per-object provenance
// probes, a free-list fragmentation walk, and the monotonic clock the
// ctime stamps are taken against (so readers can turn ctime_sec into an
// age without guessing the clock base).

// CLOCK_MONOTONIC seconds — the base of every ctime_sec stamp.
uint64_t rt_now_sec(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec;
}

// Per-object info probe — no pin, no LRU touch, no payload access.
// out[8]: data_size, meta_size, pin_count, stripe (owning stripe, or a
// span's first stripe), ctime_sec, is_span, sealed, flags.
// Returns 0 on a live object, -ENOENT otherwise. Spans are read
// lock-free (advisory snapshot, same contract as rt_span_stats);
// entries confirm under the owning stripe's lock so a racing free can't
// hand back a reused slot's fields.
int64_t rt_object_info(void* hs, const uint8_t* id, uint64_t* out) {
  Store* s = static_cast<Store*>(hs);
  memset(out, 0, 8 * sizeof(uint64_t));
  {
    int k = span_find(s, id);
    if (k >= 0) {
      SpanDesc* d = &s->hdr->spans[k];
      uint32_t st = ld32(&d->state);
      if (st == kSpanCreated || st == kSpanSealed) {
        out[0] = d->data_size;
        out[1] = d->meta_size;
        out[2] = ld32(&d->pin_count, __ATOMIC_RELAXED);
        out[3] = d->first_stripe;
        out[4] = d->ctime_sec;
        out[5] = 1;
        out[6] = st == kSpanSealed ? 1 : 0;
        out[7] = d->flags;
        return 0;
      }
    }
  }
  return with_entry_locked(s, id, [&](uint32_t si, uint32_t idx) {
    Entry* e = &s->table[idx];
    out[0] = e->data_size;
    out[1] = e->meta_size;
    out[2] = ld32(&e->pin_count, __ATOMIC_RELAXED);
    out[3] = si;
    out[4] = e->ctime_sec;
    out[5] = 0;
    out[6] = ld32(&e->state) == kSealed ? 1 : 0;
    out[7] = e->flags;
    return (int64_t)0;
  });
}

// Fragmentation walk of ONE stripe's free list (under its lock — this
// is a diagnostic path polled at census cadence, not a hot path).
// out[4]: free_bytes (sum of free block sizes incl. headers),
// largest_hole (largest free block, i.e. the biggest single allocation
// the stripe could serve +/- header/alignment), free_blocks,
// bytes_in_use. A stripe claimed by a spanning object reports zero
// free bytes — its heap belongs to the span wholesale.
void rt_stripe_frag(void* hs, uint32_t stripe, uint64_t* out) {
  Store* s = static_cast<Store*>(hs);
  memset(out, 0, 4 * sizeof(uint64_t));
  if (stripe >= s->hdr->num_stripes) return;
  Stripe* sp = &s->hdr->stripes[stripe];
  StripeGuard g(s, stripe);
  if (sp->span_owner) {
    out[3] = sp->arena_size;
    return;
  }
  uint64_t off = sp->free_head;
  while (off != kNone) {
    Block* b = at(s, sp, off);
    uint64_t sz = blk_size(b);
    out[0] += sz;
    if (sz > out[1]) out[1] = sz;
    out[2]++;
    off = b->next_free;
  }
  out[3] = sp->bytes_in_use;
}

// ------------------------------------------------- spanning-object ABI

// Largest payload (data+meta) the per-stripe allocator can hold; one
// byte more routes to the spanning path. Lets clients and benches pick
// sizes that deterministically exercise either side.
uint64_t rt_max_alloc_bytes(void* hs) {
  Store* s = static_cast<Store*>(hs);
  uint64_t sz = s->hdr->stripes[0].arena_size;
  return (sz & ~(kAlign - 1)) - kBlockHeader;
}

// Force the spanning path regardless of size (tests exercise span
// machinery without multi-GB arenas). Same contract as rt_create.
int64_t rt_create_spanning(void* hs, const uint8_t* id, uint64_t data_size,
                           uint64_t meta_size, int evictable) {
  Store* s = static_cast<Store*>(hs);
  if (data_size + meta_size == 0) return -EINVAL;
  if (rt_contains(hs, id)) return -EEXIST;
  return span_create(s, id, data_size, meta_size, evictable);
}

// 1 when id names a live spanning object (created or sealed).
int rt_is_span(void* hs, const uint8_t* id) {
  return span_find(static_cast<Store*>(hs), id) >= 0 ? 1 : 0;
}

// Span-plane snapshot (lock-free reads; counters are advisory).
// out[8]: live_spans, span_bytes (data+meta of live spans),
// stripes_claimed, span_creates, span_evictions, span_repairs,
// broken_slots, max_span_bytes (whole-arena ceiling for one object).
void rt_span_stats(void* hs, uint64_t* out) {
  Store* s = static_cast<Store*>(hs);
  Header* h = s->hdr;
  memset(out, 0, 8 * sizeof(uint64_t));
  for (uint32_t k = 0; k < kMaxSpans; ++k) {
    SpanDesc* d = &h->spans[k];
    uint32_t st = ld32(&d->state);
    if (st == kSpanCreated || st == kSpanSealed) {
      out[0]++;
      out[1] += d->data_size + d->meta_size;
    } else if (st == kSpanBroken) {
      out[6]++;
    }
  }
  for (uint32_t si = 0; si < h->num_stripes; ++si)
    if (ld32(&h->stripes[si].span_owner, __ATOMIC_RELAXED)) out[2]++;
  out[3] = ld64(&h->span_creates, __ATOMIC_RELAXED);
  out[4] = ld64(&h->span_evictions, __ATOMIC_RELAXED);
  out[5] = ld64(&h->span_repairs, __ATOMIC_RELAXED);
  out[7] = (uint64_t)h->num_stripes * h->stripes[0].arena_size;
}

}  // extern "C"
