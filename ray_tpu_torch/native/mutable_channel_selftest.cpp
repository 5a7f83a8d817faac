// Standalone ASan/UBSan harness for the mutable shared-memory channel
// (the compiled-graph channel substrate); built by native/build.py
// build_selftest and run as a subprocess by
// tests/test_torch_dag_channels.py.
//
// Exercises: writer/reader version-gated handoff over many rounds with
// 2 reader threads on separate opens (cross-mapping coherence), payload
// integrity per version, write_acquire back-pressure until every reader
// acks, timeout paths, and closed-channel propagation.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* rtc_create(const char* path, uint64_t max_size, uint32_t num_readers);
void* rtc_open(const char* path);
void rtc_close(void* hc);
uint8_t* rtc_payload(void* hc);
uint64_t rtc_max_size(void* hc);
int rtc_write_acquire(void* hc, int64_t timeout_ms);
int rtc_write_publish(void* hc, uint64_t data_size);
int64_t rtc_read_acquire(void* hc, uint64_t last_version,
                         int64_t timeout_ms, uint64_t* data_size);
int rtc_read_release(void* hc, uint64_t version);
int rtc_set_closed(void* hc);
uint64_t rtc_version(void* hc);
}

#define CHECK(cond)                                                    \
  do {                                                                 \
    if (!(cond)) {                                                     \
      fprintf(stderr, "CHECK failed at %s:%d: %s\n", __FILE__,         \
              __LINE__, #cond);                                        \
      exit(1);                                                         \
    }                                                                  \
  } while (0)

static constexpr int kRounds = 200;
static constexpr uint64_t kPayload = 4096;

int main(int argc, char** argv) {
  std::string path = argc > 1 ? argv[1] : "/dev/shm/raytpu_torch_rtc_selftest";
  void* w = rtc_create(path.c_str(), kPayload, 2);
  CHECK(w != nullptr);
  CHECK(rtc_max_size(w) == kPayload);

  // read timeout on an empty channel
  uint64_t dsz = 0;
  void* probe = rtc_open(path.c_str());
  CHECK(probe != nullptr);
  CHECK(rtc_read_acquire(probe, 0, 50, &dsz) == 0);  // timeout
  rtc_close(probe);

  std::atomic<int> failures{0};
  auto reader = [&](int rid) {
    void* r = rtc_open(path.c_str());
    if (!r) { failures++; return; }
    uint8_t* buf = rtc_payload(r);
    uint64_t last = 0;
    for (;;) {
      uint64_t sz = 0;
      int64_t v = rtc_read_acquire(r, last, 5000, &sz);
      if (v == -2) break;          // closed and drained
      if (v <= 0) { failures++; break; }
      // payload integrity: every byte stamps the version
      if (sz != kPayload) failures++;
      for (uint64_t k = 0; k < sz; k += 97)
        if (buf[k] != (uint8_t)(v & 0xff)) { failures++; break; }
      rtc_read_release(r, (uint64_t)v);
      last = (uint64_t)v;
    }
    rtc_close(r);
  };

  std::thread t1(reader, 1), t2(reader, 2);

  uint8_t* wbuf = rtc_payload(w);
  for (int round = 1; round <= kRounds; round++) {
    CHECK(rtc_write_acquire(w, 5000) == 0);  // waits for both acks
    memset(wbuf, round & 0xff, kPayload);
    CHECK(rtc_write_publish(w, kPayload) == 0);
  }
  // wait until the final version is fully acked, then close
  CHECK(rtc_write_acquire(w, 5000) == 0);
  CHECK(rtc_version(w) == (uint64_t)kRounds);
  CHECK(rtc_set_closed(w) == 0);
  t1.join();
  t2.join();
  CHECK(failures.load() == 0);

  // writes on a closed channel fail
  CHECK(rtc_write_acquire(w, 100) == -2);
  rtc_close(w);
  remove(path.c_str());
  printf("mutable_channel_selftest: OK\n");
  return 0;
}
