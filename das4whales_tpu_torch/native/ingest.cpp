// Native host-side ingest engine for das4whales_tpu_torch (a copy of the
// JAX package's native/ingest.cpp, the same C ABI).
//
// The reference package delegates all bulk I/O to h5py's C core and does
// raw->strain conditioning in numpy on the Python thread
// (data_handle.py:180-230, data_handle.py:157-177). Here the bulk path is
// first-party native code: the Python layer asks h5py for the *metadata*
// (shape, dtype, contiguous byte offset) once, and this engine does the
// heavy lifting —
//
//   * strided channel reads straight from the file via pread(2), parallel
//     across channels with a thread pool (no GIL, no intermediate Python
//     objects);
//   * fused int->float32 conversion + per-channel demean + scale-to-strain
//     in the same pass over the bytes (one read, one write per element);
//   * an asynchronous prefetch pipeline (submit/wait tickets) so the host
//     reads+conditions file k+1 while the card computes on file k. Workers
//     write directly into caller-owned buffers: zero internal copies.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// Build: das4whales_tpu_torch/io/native.py runs g++ -O3 -std=c++17 -shared
// -fPIC -pthread at first use, into build/native/ at the repository root.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

// dtype codes shared with the ctypes wrapper (io/native.py).
enum DType : int32_t {
  DT_I16 = 0,
  DT_I32 = 1,
  DT_F32 = 2,
  DT_F64 = 3,
};

inline int64_t itemsize(int32_t dt) {
  switch (dt) {
    case DT_I16: return 2;
    case DT_I32: return 4;
    case DT_F32: return 4;
    case DT_F64: return 8;
  }
  return 0;
}

// Read exactly `len` bytes at `off` (pread can return short counts).
bool pread_full(int fd, void* buf, int64_t len, int64_t off) {
  char* p = static_cast<char*>(buf);
  while (len > 0) {
    ssize_t got = ::pread(fd, p, static_cast<size_t>(len), static_cast<off_t>(off));
    if (got <= 0) return false;
    p += got;
    off += got;
    len -= got;
  }
  return true;
}

// Convert one channel row of `ns` raw samples to float32, optionally fused
// with demean (mean accumulated in double) and scale-to-strain
// (data_handle.py:157-177 semantics). `raw` is the packed on-disk row.
template <typename T>
void condition_row(const T* raw, float* out, int64_t ns, bool fuse, double scale) {
  if (!fuse) {
    for (int64_t j = 0; j < ns; ++j) out[j] = static_cast<float>(raw[j]);
    return;
  }
  double acc = 0.0;
  for (int64_t j = 0; j < ns; ++j) acc += static_cast<double>(raw[j]);
  const double mean = ns > 0 ? acc / static_cast<double>(ns) : 0.0;
  for (int64_t j = 0; j < ns; ++j)
    out[j] = static_cast<float>((static_cast<double>(raw[j]) - mean) * scale);
}

void condition_dispatch(const void* raw, int32_t dt, float* out, int64_t ns,
                        bool fuse, double scale) {
  switch (dt) {
    case DT_I16: condition_row(static_cast<const int16_t*>(raw), out, ns, fuse, scale); break;
    case DT_I32: condition_row(static_cast<const int32_t*>(raw), out, ns, fuse, scale); break;
    case DT_F32: condition_row(static_cast<const float*>(raw), out, ns, fuse, scale); break;
    case DT_F64: condition_row(static_cast<const double*>(raw), out, ns, fuse, scale); break;
  }
}

struct ReadJob {
  std::string path;
  int64_t offset = 0;      // byte offset of the [nx x ns] dataset in the file
  int32_t dtype = DT_I32;
  int64_t nx = 0, ns = 0;  // on-disk dataset shape
  int64_t start = 0, stop = 0, step = 1;  // channel selection
  int32_t fuse = 1;
  double scale = 1.0;
  float* out = nullptr;    // caller-owned [n_sel x ns] float32 buffer
};

inline int64_t n_selected(const ReadJob& j) {
  if (j.stop <= j.start || j.step <= 0) return 0;
  return (j.stop - j.start + j.step - 1) / j.step;
}

// Synchronous strided read of one job, channel-parallel over `nthreads`.
// Returns 0 on success, negative errno-style codes on failure.
int run_job(const ReadJob& job, int nthreads) {
  const int64_t nsel = n_selected(job);
  if (nsel <= 0 || job.ns <= 0 || job.start < 0 || job.offset < 0)
    return -22;  // EINVAL: a negative start would pread file-header bytes
  const int64_t isz = itemsize(job.dtype);
  if (isz == 0) return -22;
  if (job.start + (nsel - 1) * job.step >= job.nx) return -34;  // ERANGE

  int fd = ::open(job.path.c_str(), O_RDONLY);
  if (fd < 0) return -2;  // ENOENT-ish

  const int nt = std::max(1, std::min<int>(nthreads, static_cast<int>(nsel)));
  std::atomic<int64_t> next{0};
  std::atomic<int> err{0};
  const int64_t row_bytes = job.ns * isz;

  auto worker = [&]() {
    std::vector<char> raw(static_cast<size_t>(row_bytes));
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= nsel || err.load(std::memory_order_relaxed)) break;
      const int64_t ch = job.start + i * job.step;
      const int64_t off = job.offset + ch * row_bytes;
      if (!pread_full(fd, raw.data(), row_bytes, off)) {
        err.store(-5);  // EIO
        break;
      }
      condition_dispatch(raw.data(), job.dtype, job.out + i * job.ns, job.ns,
                         job.fuse != 0, job.scale);
    }
  };

  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  ::close(fd);
  return err.load();
}

// ---------------------------------------------------------------------------
// Async prefetch pipeline: bounded worker pool + ticketed completion.
// ---------------------------------------------------------------------------

struct Pipeline {
  explicit Pipeline(int nthreads, int io_threads_per_job)
      : io_threads(std::max(1, io_threads_per_job)) {
    const int nt = std::max(1, nthreads);
    workers.reserve(nt);
    for (int t = 0; t < nt; ++t) workers.emplace_back([this]() { loop(); });
  }

  ~Pipeline() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_jobs.notify_all();
    for (auto& th : workers) th.join();
  }

  int64_t submit(ReadJob job) {
    std::lock_guard<std::mutex> lk(mu);
    const int64_t ticket = next_ticket++;
    queue.push_back({ticket, std::move(job)});
    cv_jobs.notify_one();
    return ticket;
  }

  int wait(int64_t ticket) {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&]() { return done.count(ticket) != 0; });
    const int rc = done[ticket];
    done.erase(ticket);
    return rc;
  }

 private:
  void loop() {
    for (;;) {
      std::pair<int64_t, ReadJob> item;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_jobs.wait(lk, [&]() { return stopping || !queue.empty(); });
        if (stopping && queue.empty()) return;
        item = std::move(queue.front());
        queue.pop_front();
      }
      const int rc = run_job(item.second, io_threads);
      {
        std::lock_guard<std::mutex> lk(mu);
        done[item.first] = rc;
      }
      cv_done.notify_all();
    }
  }

  const int io_threads;
  std::mutex mu;
  std::condition_variable cv_jobs, cv_done;
  std::deque<std::pair<int64_t, ReadJob>> queue;
  std::unordered_map<int64_t, int> done;
  std::vector<std::thread> workers;
  int64_t next_ticket = 0;
  bool stopping = false;
};

}  // namespace

extern "C" {

int32_t dw_abi_version() { return 1; }

// Synchronous strided read (+ optional fused conditioning) into `out`
// ([n_sel x ns] float32, caller-owned). Returns 0 on success.
int32_t dw_read_strided(const char* path, int64_t offset, int32_t dtype,
                        int64_t nx, int64_t ns, int64_t start, int64_t stop,
                        int64_t step, int32_t fuse, double scale,
                        int32_t nthreads, float* out) {
  ReadJob job;
  job.path = path;
  job.offset = offset;
  job.dtype = dtype;
  job.nx = nx;
  job.ns = ns;
  job.start = start;
  job.stop = stop;
  job.step = step;
  job.fuse = fuse;
  job.scale = scale;
  job.out = out;
  return run_job(job, nthreads);
}

// In-place threaded demean+scale of an [nx x ns] float32 block (the
// raw2strain kernel for hosts that loaded bytes elsewhere).
int32_t dw_raw2strain_f32(float* data, int64_t nx, int64_t ns, double scale,
                          int32_t nthreads) {
  if (nx <= 0 || ns <= 0) return -22;
  const int nt = std::max(1, std::min<int>(nthreads, static_cast<int>(nx)));
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= nx) break;
      float* row = data + i * ns;
      double acc = 0.0;
      for (int64_t j = 0; j < ns; ++j) acc += row[j];
      const double mean = acc / static_cast<double>(ns);
      for (int64_t j = 0; j < ns; ++j)
        row[j] = static_cast<float>((row[j] - mean) * scale);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return 0;
}

void* dw_pipe_create(int32_t nworkers, int32_t io_threads_per_job) {
  return new Pipeline(nworkers, io_threads_per_job);
}

void dw_pipe_destroy(void* p) { delete static_cast<Pipeline*>(p); }

int64_t dw_pipe_submit(void* p, const char* path, int64_t offset, int32_t dtype,
                       int64_t nx, int64_t ns, int64_t start, int64_t stop,
                       int64_t step, int32_t fuse, double scale, float* out) {
  ReadJob job;
  job.path = path;
  job.offset = offset;
  job.dtype = dtype;
  job.nx = nx;
  job.ns = ns;
  job.start = start;
  job.stop = stop;
  job.step = step;
  job.fuse = fuse;
  job.scale = scale;
  job.out = out;
  return static_cast<Pipeline*>(p)->submit(std::move(job));
}

int32_t dw_pipe_wait(void* p, int64_t ticket) {
  return static_cast<Pipeline*>(p)->wait(ticket);
}

}  // extern "C"
