// Async block IO for weight/plaintext streaming, copied from ace_tpu's
// native/block_io.cc — the analog of the reference runtime's io_uring
// block reader (rtlib common/src/block_io_linux.c:10-22): the compiled
// graph consumes pre-encoded plaintexts in a known order, so the loader
// reads ahead of the op stream without blocking the dispatch thread.
// ace_tpu_torch/runtime/block_io.py builds it with g++ into the build
// directory on first use.
//
// Two engines behind one C API (chosen at open time):
//   - io_uring via raw syscalls (no liburing in the image): one SQ/CQ
//     pair per loader, IORING_OP_READ submissions, completions drained
//     on demand.
//   - portable fallback: a small pthread pool issuing pread(2), used
//     when io_uring_setup is unavailable (seccomp/older kernels).
//
// The API is completion-token based so Python (ctypes) can overlap
// device compute with disk reads:
//   h   = bio_open(path, queue_depth)      // < 0 on error
//   tok = bio_submit(h, off, len, buf)     // returns token >= 0
//   bio_wait(h, tok)                       // block until THAT read done
//   bio_engine(h)                          // 1 = io_uring, 0 = threads
//   bio_close(h)

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <thread>
#include <unistd.h>
#include <vector>

#include <linux/io_uring.h>

namespace {

// ---------------------------------------------------------------- io_uring
static int sys_io_uring_setup(unsigned entries, struct io_uring_params *p) {
  return (int)syscall(__NR_io_uring_setup, entries, p);
}
static int sys_io_uring_enter(int fd, unsigned to_submit,
                              unsigned min_complete, unsigned flags) {
  return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete,
                      flags, nullptr, 0);
}

struct UringLoader {
  int ring_fd = -1;
  int file_fd = -1;
  unsigned sq_entries = 0, cq_entries = 0;
  // SQ ring
  void *sq_ring = nullptr;
  size_t sq_ring_sz = 0;
  unsigned *sq_head = nullptr, *sq_tail = nullptr, *sq_mask = nullptr;
  unsigned *sq_array = nullptr;
  struct io_uring_sqe *sqes = nullptr;
  size_t sqes_sz = 0;
  // CQ ring
  void *cq_ring = nullptr;
  size_t cq_ring_sz = 0;
  unsigned *cq_head = nullptr, *cq_tail = nullptr, *cq_mask = nullptr;
  struct io_uring_cqe *cqes = nullptr;

  std::mutex mu;
  uint64_t next_tok = 0;
  std::map<uint64_t, int64_t> done;  // token -> result (total bytes or -errno)
  struct Pending {                   // an in-flight (possibly partial) read
    char *buf;
    uint64_t off, len, got;
  };
  std::map<uint64_t, Pending> pending;  // token -> progress
  unsigned inflight = 0;

  bool open_rings(unsigned entries) {
    struct io_uring_params p;
    memset(&p, 0, sizeof(p));
    ring_fd = sys_io_uring_setup(entries, &p);
    if (ring_fd < 0) return false;
    sq_entries = p.sq_entries;
    cq_entries = p.cq_entries;
    sq_ring_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_ring_sz = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
    bool single_map = p.features & IORING_FEAT_SINGLE_MMAP;
    if (single_map && cq_ring_sz > sq_ring_sz) sq_ring_sz = cq_ring_sz;
    sq_ring = mmap(nullptr, sq_ring_sz, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_SQ_RING);
    if (sq_ring == MAP_FAILED) return false;
    cq_ring = single_map
                  ? sq_ring
                  : mmap(nullptr, cq_ring_sz, PROT_READ | PROT_WRITE,
                         MAP_SHARED | MAP_POPULATE, ring_fd,
                         IORING_OFF_CQ_RING);
    if (cq_ring == MAP_FAILED) return false;
    auto *sqb = (char *)sq_ring;
    sq_head = (unsigned *)(sqb + p.sq_off.head);
    sq_tail = (unsigned *)(sqb + p.sq_off.tail);
    sq_mask = (unsigned *)(sqb + p.sq_off.ring_mask);
    sq_array = (unsigned *)(sqb + p.sq_off.array);
    sqes_sz = p.sq_entries * sizeof(io_uring_sqe);
    sqes = (io_uring_sqe *)mmap(nullptr, sqes_sz, PROT_READ | PROT_WRITE,
                                MAP_SHARED | MAP_POPULATE, ring_fd,
                                IORING_OFF_SQES);
    if (sqes == MAP_FAILED) return false;
    auto *cqb = (char *)cq_ring;
    cq_head = (unsigned *)(cqb + p.cq_off.head);
    cq_tail = (unsigned *)(cqb + p.cq_off.tail);
    cq_mask = (unsigned *)(cqb + p.cq_off.ring_mask);
    cqes = (io_uring_cqe *)(cqb + p.cq_off.cqes);
    return true;
  }

  // Write one SQE and hand it to the kernel. EINTR-retried; on hard
  // failure the SQ tail is rolled back so no stale SQE pointing at a
  // (soon to be freed) buffer can be picked up by a later enter().
  // Caller holds mu. Returns 0 on success, -1 on failure.
  int push_sqe_locked(uint64_t tok, char *buf, uint64_t off, uint64_t len) {
    unsigned tail = __atomic_load_n(sq_tail, __ATOMIC_ACQUIRE);
    unsigned idx = tail & *sq_mask;
    io_uring_sqe *s = &sqes[idx];
    memset(s, 0, sizeof(*s));
    s->opcode = IORING_OP_READ;
    s->fd = file_fd;
    s->addr = (uint64_t)buf;
    s->len = (unsigned)len;
    s->off = off;
    s->user_data = tok;
    sq_array[idx] = idx;
    __atomic_store_n(sq_tail, tail + 1, __ATOMIC_RELEASE);
    int r;
    do {
      r = sys_io_uring_enter(ring_fd, 1, 0, 0);
    } while (r < 0 && errno == EINTR);
    if (r < 0) {
      __atomic_store_n(sq_tail, tail, __ATOMIC_RELEASE);
      return -1;
    }
    inflight++;
    return 0;
  }

  // drain any available completions into `done` (caller holds mu).
  // Short non-EOF reads are resubmitted for the remainder (buffered
  // IORING_OP_READ may legally return early), mirroring the thread-pool
  // fallback's pread loop.
  void reap_locked() {
    unsigned head = __atomic_load_n(cq_head, __ATOMIC_ACQUIRE);
    unsigned tail = __atomic_load_n(cq_tail, __ATOMIC_ACQUIRE);
    while (head != tail) {
      io_uring_cqe c = cqes[head & *cq_mask];
      head++;
      __atomic_store_n(cq_head, head, __ATOMIC_RELEASE);
      inflight--;
      auto it = pending.find(c.user_data);
      if (it == pending.end()) continue;  // cancelled/unknown
      Pending &p = it->second;
      if (c.res == -EINTR || c.res == -EAGAIN) {
        // transient: retry the remaining extent
        if (push_sqe_locked(it->first, p.buf + p.got, p.off + p.got,
                            p.len - p.got) == 0)
          continue;
        done[it->first] = -EIO;
        pending.erase(it);
      } else if (c.res < 0) {
        done[it->first] = c.res;
        pending.erase(it);
      } else {
        p.got += (uint64_t)c.res;
        if (c.res == 0 || p.got >= p.len) {
          done[it->first] = (int64_t)p.got;  // complete (or true EOF-short)
          pending.erase(it);
        } else if (push_sqe_locked(it->first, p.buf + p.got, p.off + p.got,
                                   p.len - p.got) != 0) {
          done[it->first] = (int64_t)p.got;  // report progress; caller errors
          pending.erase(it);
        }
      }
      tail = __atomic_load_n(cq_tail, __ATOMIC_ACQUIRE);
    }
  }

  int64_t submit(uint64_t off, uint64_t len, void *buf) {
    std::unique_lock<std::mutex> g(mu);
    reap_locked();
    while (inflight >= sq_entries) {
      // SQ full: wait for one completion inline, then re-check
      g.unlock();
      int r;
      do {
        r = sys_io_uring_enter(ring_fd, 0, 1, IORING_ENTER_GETEVENTS);
      } while (r < 0 && errno == EINTR);
      g.lock();
      reap_locked();
      if (r < 0) return -1;
    }
    uint64_t tok = next_tok++;
    pending[tok] = Pending{(char *)buf, off, len, 0};
    if (push_sqe_locked(tok, (char *)buf, off, len) != 0) {
      pending.erase(tok);
      return -1;
    }
    return (int64_t)tok;
  }

  int64_t wait(uint64_t tok) {
    for (;;) {
      {
        std::lock_guard<std::mutex> g(mu);
        reap_locked();
        auto it = done.find(tok);
        if (it != done.end()) {
          int64_t r = it->second;
          done.erase(it);
          return r;
        }
      }
      sys_io_uring_enter(ring_fd, 0, 1, IORING_ENTER_GETEVENTS);
    }
  }

  ~UringLoader() {
    if (sqes && sqes != MAP_FAILED) munmap(sqes, sqes_sz);
    if (cq_ring && cq_ring != MAP_FAILED && cq_ring != sq_ring)
      munmap(cq_ring, cq_ring_sz);
    if (sq_ring && sq_ring != MAP_FAILED) munmap(sq_ring, sq_ring_sz);
    if (ring_fd >= 0) close(ring_fd);
    if (file_fd >= 0) close(file_fd);
  }
};

// ------------------------------------------------------------- thread pool
struct PoolLoader {
  int file_fd = -1;
  struct Req {
    uint64_t tok, off, len;
    void *buf;
  };
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::deque<Req> queue;
  std::map<uint64_t, int64_t> done;
  uint64_t next_tok = 0;
  bool stop = false;
  std::vector<std::thread> threads;

  void start(int n) {
    for (int i = 0; i < n; i++)
      threads.emplace_back([this] {
        for (;;) {
          Req r;
          {
            std::unique_lock<std::mutex> lk(mu);
            cv_work.wait(lk, [this] { return stop || !queue.empty(); });
            if (stop && queue.empty()) return;
            r = queue.front();
            queue.pop_front();
          }
          int64_t n = 0;
          uint64_t got = 0;
          while (got < r.len) {
            n = pread(file_fd, (char *)r.buf + got, r.len - got,
                      (off_t)(r.off + got));
            if (n <= 0) break;
            got += (uint64_t)n;
          }
          std::lock_guard<std::mutex> g(mu);
          done[r.tok] = n < 0 ? n : (int64_t)got;
          cv_done.notify_all();
        }
      });
  }

  int64_t submit(uint64_t off, uint64_t len, void *buf) {
    std::lock_guard<std::mutex> g(mu);
    uint64_t tok = next_tok++;
    queue.push_back({tok, off, len, buf});
    cv_work.notify_one();
    return (int64_t)tok;
  }

  int64_t wait(uint64_t tok) {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&] { return done.count(tok) != 0; });
    int64_t r = done[tok];
    done.erase(tok);
    return r;
  }

  ~PoolLoader() {
    {
      std::lock_guard<std::mutex> g(mu);
      stop = true;
      cv_work.notify_all();
    }
    for (auto &t : threads) t.join();
    if (file_fd >= 0) close(file_fd);
  }
};

struct Loader {
  UringLoader *uring = nullptr;
  PoolLoader *pool = nullptr;
};

std::mutex g_mu;
std::map<int, Loader> g_loaders;
int g_next = 1;

}  // namespace

extern "C" {

int bio_open(const char *path, int queue_depth) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  Loader L;
  auto *u = new UringLoader();
  if (u->open_rings((unsigned)queue_depth)) {
    u->file_fd = fd;
    L.uring = u;
  } else {
    delete u;
    auto *p = new PoolLoader();
    p->file_fd = fd;
    p->start(queue_depth < 4 ? queue_depth : 4);
    L.pool = p;
  }
  std::lock_guard<std::mutex> g(g_mu);
  int h = g_next++;
  g_loaders[h] = L;
  return h;
}

int bio_engine(int h) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_loaders.find(h);
  if (it == g_loaders.end()) return -1;
  return it->second.uring ? 1 : 0;
}

int64_t bio_submit(int h, uint64_t off, uint64_t len, void *buf) {
  Loader L;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_loaders.find(h);
    if (it == g_loaders.end()) return -1;
    L = it->second;
  }
  return L.uring ? L.uring->submit(off, len, buf)
                 : L.pool->submit(off, len, buf);
}

int64_t bio_wait(int h, uint64_t tok) {
  Loader L;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_loaders.find(h);
    if (it == g_loaders.end()) return -1;
    L = it->second;
  }
  return L.uring ? L.uring->wait(tok) : L.pool->wait(tok);
}

void bio_close(int h) {
  Loader L;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_loaders.find(h);
    if (it == g_loaders.end()) return;
    L = it->second;
    g_loaders.erase(it);
  }
  delete L.uring;
  delete L.pool;
}

}  // extern "C"
