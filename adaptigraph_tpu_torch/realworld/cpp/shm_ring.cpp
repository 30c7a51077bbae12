// Lock-free shared-memory ring buffer for the sensor/robot process tier.
//
// C++ equivalent of the reference's Python SharedMemoryRingBuffer
// (reference: src/planning/real_world/shared_memory/shared_memory_ring_buffer.py:18-219):
// single writer (a camera child process), multiple readers, no locks.
// Differences are deliberate hardening: per-slot seqlocks (writer sets the
// slot sequence odd before copying, even after, with release ordering;
// readers retry on a torn read) instead of the reference's convention-only
// safety, and POSIX shm_open so non-Python producers can attach.
//
// Layout in the shared segment:
//   Header { magic, elem_bytes, capacity, atomic<uint64> count }
//   capacity * { atomic<uint64> seq; double timestamp; pad; elem_bytes data }

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52494e474255461eULL;  // "RINGBUF"

struct Header {
  uint64_t magic;
  uint64_t elem_bytes;
  uint64_t capacity;
  std::atomic<uint64_t> count;  // total puts ever; latest slot = (count-1) % capacity
};

struct SlotHeader {
  std::atomic<uint64_t> seq;  // odd while being written
  double timestamp;
  uint64_t pad_;
};

struct Ring {
  Header* hdr;
  uint8_t* base;
  size_t map_bytes;
  std::string name;
  bool owner;
};

size_t slot_stride(uint64_t elem_bytes) {
  size_t s = sizeof(SlotHeader) + elem_bytes;
  return (s + 63) & ~size_t(63);  // cache-line align slots
}

SlotHeader* slot(Ring* r, uint64_t i) {
  return reinterpret_cast<SlotHeader*>(
      r->base + sizeof(Header) + i * slot_stride(r->hdr->elem_bytes));
}

uint8_t* slot_data(SlotHeader* s) {
  return reinterpret_cast<uint8_t*>(s) + sizeof(SlotHeader);
}

Ring* map_ring(const char* name, int fd, size_t bytes, bool owner) {
  void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) return nullptr;
  Ring* r = new Ring();
  r->base = static_cast<uint8_t*>(p);
  r->hdr = reinterpret_cast<Header*>(p);
  r->map_bytes = bytes;
  r->name = name;
  r->owner = owner;
  return r;
}

}  // namespace

extern "C" {

void* shm_ring_create(const char* name, uint64_t elem_bytes, uint64_t capacity) {
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t bytes = sizeof(Header) + capacity * slot_stride(elem_bytes);
  if (ftruncate(fd, (off_t)bytes) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  Ring* r = map_ring(name, fd, bytes, /*owner=*/true);
  if (!r) {
    shm_unlink(name);
    return nullptr;
  }
  r->hdr->magic = kMagic;
  r->hdr->elem_bytes = elem_bytes;
  r->hdr->capacity = capacity;
  r->hdr->count.store(0, std::memory_order_release);
  for (uint64_t i = 0; i < capacity; ++i) slot(r, i)->seq.store(0, std::memory_order_relaxed);
  return r;
}

void* shm_ring_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  Header probe;
  if (read(fd, &probe, sizeof(probe)) != sizeof(probe) || probe.magic != kMagic) {
    close(fd);
    return nullptr;
  }
  size_t bytes = sizeof(Header) + probe.capacity * slot_stride(probe.elem_bytes);
  lseek(fd, 0, SEEK_SET);
  return map_ring(name, fd, bytes, /*owner=*/false);
}

uint64_t shm_ring_elem_bytes(void* h) { return static_cast<Ring*>(h)->hdr->elem_bytes; }
uint64_t shm_ring_capacity(void* h) { return static_cast<Ring*>(h)->hdr->capacity; }

uint64_t shm_ring_count(void* h) {
  return static_cast<Ring*>(h)->hdr->count.load(std::memory_order_acquire);
}

// Single-writer put. Returns the new total count.
uint64_t shm_ring_put(void* h, const void* data, uint64_t bytes, double timestamp) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t n = r->hdr->count.load(std::memory_order_relaxed);
  SlotHeader* s = slot(r, n % r->hdr->capacity);
  uint64_t seq0 = s->seq.load(std::memory_order_relaxed);
  s->seq.store(seq0 + 1, std::memory_order_release);  // odd: write in progress
  std::atomic_thread_fence(std::memory_order_release);
  s->timestamp = timestamp;
  uint64_t m = bytes < r->hdr->elem_bytes ? bytes : r->hdr->elem_bytes;
  std::memcpy(slot_data(s), data, m);
  s->seq.store(seq0 + 2, std::memory_order_release);  // even: stable
  r->hdr->count.store(n + 1, std::memory_order_release);
  return n + 1;
}

// Read the k-th most recent element (k=0 -> latest). Returns 0 on success,
// -1 if empty / k out of range, retries internally on torn reads.
int shm_ring_get(void* h, uint64_t k, void* out, double* timestamp) {
  Ring* r = static_cast<Ring*>(h);
  for (int attempt = 0; attempt < 1024; ++attempt) {
    uint64_t n = r->hdr->count.load(std::memory_order_acquire);
    if (n == 0 || k >= n || k >= r->hdr->capacity) return -1;
    SlotHeader* s = slot(r, (n - 1 - k) % r->hdr->capacity);
    uint64_t s0 = s->seq.load(std::memory_order_acquire);
    if (s0 & 1) continue;  // being written
    double ts = s->timestamp;
    std::memcpy(out, slot_data(s), r->hdr->elem_bytes);
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t s1 = s->seq.load(std::memory_order_acquire);
    uint64_t n1 = r->hdr->count.load(std::memory_order_acquire);
    // stable iff the slot seq did not change and the writer did not lap us
    if (s1 == s0 && n1 - (n - 1 - k) <= r->hdr->capacity) {
      if (timestamp) *timestamp = ts;
      return 0;
    }
  }
  return -2;  // persistent contention (writer much faster than reader)
}

// Read the last k elements, oldest first. Returns number actually read.
int shm_ring_get_last_k(void* h, uint64_t k, void* out, double* timestamps) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t n = r->hdr->count.load(std::memory_order_acquire);
  uint64_t avail = n < r->hdr->capacity ? n : r->hdr->capacity;
  if (k > avail) k = avail;
  uint64_t eb = r->hdr->elem_bytes;
  int got = 0;
  for (uint64_t i = 0; i < k; ++i) {
    uint64_t back = k - 1 - i;  // oldest first
    if (shm_ring_get(h, back, static_cast<uint8_t*>(out) + i * eb,
                     timestamps ? timestamps + i : nullptr) == 0) {
      ++got;
    }
  }
  return got;
}

void shm_ring_close(void* h) {
  Ring* r = static_cast<Ring*>(h);
  munmap(r->base, r->map_bytes);
  if (r->owner) shm_unlink(r->name.c_str());
  delete r;
}

void shm_ring_unlink(const char* name) { shm_unlink(name); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Lock-free FIFO queue (single producer / single consumer) over POSIX shm.
//
// C++ equivalent of the reference's Python SharedMemoryQueue
// (reference: src/planning/real_world/shared_memory/shared_memory_queue.py:10-187):
// a bounded FIFO of fixed-size records guarded by two atomic counters
// (write_count / read_count), used as the command plane between the parent
// and camera/robot child processes. Unlike the ring above (newest-first
// sampling, writer may lap readers), the queue is consume-once and reports
// Full/Empty to the caller.
// ---------------------------------------------------------------------------

namespace {

constexpr uint64_t kQueueMagic = 0x53504d5146494f31ULL;  // "SPMQFIO1"

struct QHeader {
  uint64_t magic;
  uint64_t elem_bytes;
  uint64_t capacity;
  std::atomic<uint64_t> write_count;
  std::atomic<uint64_t> read_count;
};

size_t q_stride(uint64_t elem_bytes) { return (elem_bytes + 63) & ~size_t(63); }

struct Queue {
  QHeader* hdr;
  uint8_t* base;
  size_t map_bytes;
  std::string name;
  bool owner;
};

uint8_t* q_slot(Queue* q, uint64_t i) {
  return q->base + sizeof(QHeader) + i * q_stride(q->hdr->elem_bytes);
}

Queue* map_queue(const char* name, int fd, size_t bytes, bool owner) {
  void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) return nullptr;
  Queue* q = new Queue();
  q->base = static_cast<uint8_t*>(p);
  q->hdr = reinterpret_cast<QHeader*>(p);
  q->map_bytes = bytes;
  q->name = name;
  q->owner = owner;
  return q;
}

}  // namespace

extern "C" {

void* shm_queue_create(const char* name, uint64_t elem_bytes, uint64_t capacity) {
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t bytes = sizeof(QHeader) + capacity * q_stride(elem_bytes);
  if (ftruncate(fd, (off_t)bytes) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  Queue* q = map_queue(name, fd, bytes, /*owner=*/true);
  if (!q) {
    shm_unlink(name);
    return nullptr;
  }
  q->hdr->magic = kQueueMagic;
  q->hdr->elem_bytes = elem_bytes;
  q->hdr->capacity = capacity;
  q->hdr->write_count.store(0, std::memory_order_release);
  q->hdr->read_count.store(0, std::memory_order_release);
  return q;
}

void* shm_queue_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  QHeader probe;
  if (read(fd, &probe, sizeof(probe)) != sizeof(probe) || probe.magic != kQueueMagic) {
    close(fd);
    return nullptr;
  }
  size_t bytes = sizeof(QHeader) + probe.capacity * q_stride(probe.elem_bytes);
  lseek(fd, 0, SEEK_SET);
  return map_queue(name, fd, bytes, /*owner=*/false);
}

uint64_t shm_queue_elem_bytes(void* h) { return static_cast<Queue*>(h)->hdr->elem_bytes; }
uint64_t shm_queue_capacity(void* h) { return static_cast<Queue*>(h)->hdr->capacity; }

uint64_t shm_queue_size(void* h) {
  Queue* q = static_cast<Queue*>(h);
  uint64_t w = q->hdr->write_count.load(std::memory_order_acquire);
  uint64_t r = q->hdr->read_count.load(std::memory_order_acquire);
  return w - r;
}

// Returns 0 on success, -1 if full (reference put raises queue.Full).
int shm_queue_put(void* h, const void* data, uint64_t bytes) {
  Queue* q = static_cast<Queue*>(h);
  uint64_t w = q->hdr->write_count.load(std::memory_order_relaxed);
  uint64_t r = q->hdr->read_count.load(std::memory_order_acquire);
  if (w - r >= q->hdr->capacity) return -1;
  uint64_t m = bytes < q->hdr->elem_bytes ? bytes : q->hdr->elem_bytes;
  std::memcpy(q_slot(q, w % q->hdr->capacity), data, m);
  q->hdr->write_count.store(w + 1, std::memory_order_release);
  return 0;
}

// Pop up to k records (FIFO order) into out. Returns the number popped
// (0 when empty; reference get/get_k raise queue.Empty — mapped in Python).
int shm_queue_get_k(void* h, uint64_t k, void* out) {
  Queue* q = static_cast<Queue*>(h);
  uint64_t r = q->hdr->read_count.load(std::memory_order_relaxed);
  uint64_t w = q->hdr->write_count.load(std::memory_order_acquire);
  uint64_t avail = w - r;
  if (k > avail) k = avail;
  uint64_t eb = q->hdr->elem_bytes;
  for (uint64_t i = 0; i < k; ++i) {
    std::memcpy(static_cast<uint8_t*>(out) + i * eb,
                q_slot(q, (r + i) % q->hdr->capacity), eb);
  }
  q->hdr->read_count.store(r + k, std::memory_order_release);
  return (int)k;
}

// Drop all pending records (reference: clear(), shared_memory_queue.py:87).
void shm_queue_clear(void* h) {
  Queue* q = static_cast<Queue*>(h);
  q->hdr->read_count.store(q->hdr->write_count.load(std::memory_order_acquire),
                           std::memory_order_release);
}

void shm_queue_close(void* h) {
  Queue* q = static_cast<Queue*>(h);
  munmap(q->base, q->map_bytes);
  if (q->owner) shm_unlink(q->name.c_str());
  delete q;
}

void shm_queue_unlink(const char* name) { shm_unlink(name); }

}  // extern "C"
