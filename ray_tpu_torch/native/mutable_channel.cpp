// mutable_channel.cpp — zero-copy mutable shared-memory channels.
//
// A host-side re-design of the reference's experimental mutable objects
// (reference: src/ray/core_worker/experimental_mutable_object_manager.h:48,
// the compiled-graph channel substrate). One writer, N readers, version-
// gated: the writer publishes version v+1 only after every reader acked
// version v; readers block for a version newer than the last they consumed.
// Unlike the reference (plasma objects + header seals + raylet push), a
// channel here is a standalone file-backed mapping with a process-shared
// mutex/condvar pair — create/open by path, no daemon involvement.
//
// Layout: [Header | payload arena (max_size bytes)]

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5250554348414e4cULL;  // "RPUCHANL"

struct Header {
  uint64_t magic;
  uint64_t max_size;
  pthread_mutex_t mu;
  pthread_cond_t cv;
  uint64_t version;        // last published version (0 = nothing yet)
  uint64_t data_size;      // payload size of current version
  uint32_t num_readers;    // required acks per version
  uint32_t acks;           // readers that consumed current version
  uint32_t closed;
  uint32_t error;
};

struct Chan {
  Header* hdr;
  uint8_t* payload;
  uint64_t map_size;
  int fd;
};

int64_t now_plus_ms(timespec* ts, int64_t timeout_ms) {
  clock_gettime(CLOCK_REALTIME, ts);
  ts->tv_sec += timeout_ms / 1000;
  ts->tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
  return 0;
}

int lock_robust(Header* h) {
  int rc = pthread_mutex_lock(&h->mu);
  if (rc == EOWNERDEAD) {
    h->error = 1;
    pthread_mutex_consistent(&h->mu);
    rc = 0;
  }
  return rc;
}

}  // namespace

extern "C" {

void* rtc_create(const char* path, uint64_t max_size, uint32_t num_readers) {
  unlink(path);
  int fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd < 0) return nullptr;
  uint64_t total = sizeof(Header) + max_size;
  if (ftruncate(fd, (off_t)total) != 0) { close(fd); return nullptr; }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { close(fd); return nullptr; }
  madvise(mem, total, MADV_HUGEPAGE);

  Header* h = static_cast<Header*>(mem);
  memset(h, 0, sizeof(Header));
  h->max_size = max_size;
  h->num_readers = num_readers;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&h->cv, &ca);
  h->magic = kMagic;
  msync(mem, sizeof(Header), MS_SYNC);

  Chan* c = new Chan{h, static_cast<uint8_t*>(mem) + sizeof(Header), total, fd};
  return c;
}

void* rtc_open(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) { close(fd); return nullptr; }
  Header* h = static_cast<Header*>(mem);
  if (h->magic != kMagic) {
    munmap(mem, (size_t)st.st_size);
    close(fd);
    return nullptr;
  }
  Chan* c = new Chan{h, static_cast<uint8_t*>(mem) + sizeof(Header),
                     (uint64_t)st.st_size, fd};
  return c;
}

void rtc_close(void* hc) {
  Chan* c = static_cast<Chan*>(hc);
  munmap(c->hdr, c->map_size);
  close(c->fd);
  delete c;
}

uint8_t* rtc_payload(void* hc) { return static_cast<Chan*>(hc)->payload; }
uint64_t rtc_max_size(void* hc) { return static_cast<Chan*>(hc)->hdr->max_size; }

// Begin a write: waits until all readers acked the previous version (or
// timeout). Returns 0 on success (payload may then be filled), -1 timeout,
// -2 closed.
int rtc_write_acquire(void* hc, int64_t timeout_ms) {
  Header* h = static_cast<Chan*>(hc)->hdr;
  timespec ts;
  now_plus_ms(&ts, timeout_ms);
  if (lock_robust(h) != 0) return -3;
  while (h->version != 0 && h->acks < h->num_readers && !h->closed) {
    int rc = pthread_cond_timedwait(&h->cv, &h->mu, &ts);
    if (rc == ETIMEDOUT) { pthread_mutex_unlock(&h->mu); return -1; }
  }
  if (h->closed) { pthread_mutex_unlock(&h->mu); return -2; }
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Publish data_size bytes already written into the payload arena.
int rtc_write_publish(void* hc, uint64_t data_size) {
  Header* h = static_cast<Chan*>(hc)->hdr;
  if (lock_robust(h) != 0) return -3;
  h->data_size = data_size;
  h->version += 1;
  h->acks = 0;
  pthread_cond_broadcast(&h->cv);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Block until a version newer than last_version exists; returns the new
// version (>0), 0 on timeout, -2 closed. data_size written through.
int64_t rtc_read_acquire(void* hc, uint64_t last_version, int64_t timeout_ms,
                         uint64_t* data_size) {
  Header* h = static_cast<Chan*>(hc)->hdr;
  timespec ts;
  now_plus_ms(&ts, timeout_ms);
  if (lock_robust(h) != 0) return -3;
  while (h->version <= last_version && !h->closed) {
    int rc = pthread_cond_timedwait(&h->cv, &h->mu, &ts);
    if (rc == ETIMEDOUT) { pthread_mutex_unlock(&h->mu); return 0; }
  }
  if (h->closed && h->version <= last_version) {
    pthread_mutex_unlock(&h->mu);
    return -2;
  }
  int64_t v = (int64_t)h->version;
  *data_size = h->data_size;
  pthread_mutex_unlock(&h->mu);
  return v;
}

// Ack the given version (reader finished with the buffer).
int rtc_read_release(void* hc, uint64_t version) {
  Header* h = static_cast<Chan*>(hc)->hdr;
  if (lock_robust(h) != 0) return -3;
  if (h->version == version) {
    h->acks += 1;
    if (h->acks >= h->num_readers) pthread_cond_broadcast(&h->cv);
  }
  pthread_mutex_unlock(&h->mu);
  return 0;
}

int rtc_set_closed(void* hc) {
  Header* h = static_cast<Chan*>(hc)->hdr;
  if (lock_robust(h) != 0) return -3;
  h->closed = 1;
  pthread_cond_broadcast(&h->cv);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

uint64_t rtc_version(void* hc) {
  return static_cast<Chan*>(hc)->hdr->version;
}

}  // extern "C"
