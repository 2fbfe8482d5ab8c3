// Native trace-IO runtime for bayesfmmm-tpu.
//
// The reference's data plane is Armadillo ascii trace files written
// synchronously from the sampling loop (BFMMM.h:1720-1730) and re-parsed by
// every post-processing call (PostProcessing.cpp:144-162).  This library
// provides the accelerator-side equivalent of that data plane:
//
//   * fast ascii matrix parsing (strtod streaming, ~10x Python's loadtxt)
//   * fast ascii writers
//   * an asynchronous batch writer: the device stays busy while a worker
//     thread drains completed trace batches to disk (the reference blocks
//     its Gibbs loop on synchronous arma::save calls).
//
// C ABI only (consumed via ctypes from bayesfmmm_tpu.io.native).

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Fast ascii parsing
// ---------------------------------------------------------------------------

// Parses an ARMA_MAT_TXT / ARMA_CUB_TXT file.  On success returns a
// malloc'd double buffer (caller frees via bfmmm_free) and fills dims[3]
// = {rows, cols, slices} (slices == 1 for matrices).  Returns nullptr on
// failure.
double* bfmmm_read_arma_ascii(const char* path, long dims[3]) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  char header[64];
  if (!std::fgets(header, sizeof header, f)) { std::fclose(f); return nullptr; }
  long rows = 0, cols = 0, slices = 1;
  bool is_cube = std::strncmp(header, "ARMA_CUB_TXT", 12) == 0;
  bool is_mat = std::strncmp(header, "ARMA_MAT_TXT", 12) == 0;
  if (!is_cube && !is_mat) { std::fclose(f); return nullptr; }
  if (is_cube) {
    if (std::fscanf(f, "%ld %ld %ld", &rows, &cols, &slices) != 3) {
      std::fclose(f); return nullptr;
    }
  } else {
    if (std::fscanf(f, "%ld %ld", &rows, &cols) != 2) {
      std::fclose(f); return nullptr;
    }
  }
  const long total = rows * cols * slices;
  double* buf = static_cast<double*>(std::malloc(sizeof(double) * total));
  if (!buf) { std::fclose(f); return nullptr; }

  // Slurp the remainder and strtod through it — far faster than fscanf.
  long start = std::ftell(f);
  std::fseek(f, 0, SEEK_END);
  long end = std::ftell(f);
  std::fseek(f, start, SEEK_SET);
  std::string text(static_cast<size_t>(end - start), '\0');
  if (std::fread(text.data(), 1, text.size(), f) != text.size()) {
    std::free(buf); std::fclose(f); return nullptr;
  }
  std::fclose(f);

  const char* p = text.c_str();
  char* next = nullptr;
  for (long i = 0; i < total; ++i) {
    double v = std::strtod(p, &next);
    if (next == p) { std::free(buf); return nullptr; }
    buf[i] = v;
    p = next;
  }
  dims[0] = rows; dims[1] = cols; dims[2] = slices;
  return buf;
}

void bfmmm_free(double* p) { std::free(p); }

// Writes rows*cols*slices doubles (row-major within each slice, slices
// consecutive — the text layout of ARMA_CUB_TXT) to path.  slices == 0
// writes an ARMA_MAT_TXT header instead.  Returns 0 on success.
int bfmmm_write_arma_ascii(const char* path, const double* data, long rows,
                           long cols, long slices) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  std::string out;
  out.reserve(static_cast<size_t>(rows) * cols * (slices ? slices : 1) * 26
              + 64);
  char num[40];
  if (slices == 0) {
    std::snprintf(num, sizeof num, "ARMA_MAT_TXT_FN008\n%ld %ld\n", rows,
                  cols);
    out += num;
    slices = 1;
  } else {
    std::snprintf(num, sizeof num, "ARMA_CUB_TXT_FN008\n%ld %ld %ld\n", rows,
                  cols, slices);
    out += num;
  }
  const double* p = data;
  for (long s = 0; s < slices; ++s) {
    for (long r = 0; r < rows; ++r) {
      for (long c = 0; c < cols; ++c) {
        std::snprintf(num, sizeof num, " %.16e", *p++);
        out += num;
      }
      out += '\n';
    }
  }
  size_t n = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return n == out.size() ? 0 : 2;
}

// ---------------------------------------------------------------------------
// Async batch writer
// ---------------------------------------------------------------------------

struct WriteJob {
  std::string path;
  std::vector<double> data;
  long rows, cols, slices;
};

struct AsyncWriter {
  std::deque<WriteJob> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;
  std::atomic<bool> stop{false};
  std::atomic<long> completed{0};
  std::atomic<long> failed{0};

  AsyncWriter() {
    worker = std::thread([this] {
      for (;;) {
        WriteJob job;
        {
          std::unique_lock<std::mutex> lk(mu);
          cv.wait(lk, [this] { return stop.load() || !queue.empty(); });
          if (queue.empty()) {
            if (stop.load()) return;
            continue;
          }
          job = std::move(queue.front());
          queue.pop_front();
        }
        int rc = bfmmm_write_arma_ascii(job.path.c_str(), job.data.data(),
                                        job.rows, job.cols, job.slices);
        if (rc == 0) completed.fetch_add(1); else failed.fetch_add(1);
      }
    });
  }
  ~AsyncWriter() {
    stop.store(true);
    cv.notify_all();
    if (worker.joinable()) worker.join();
  }
};

void* bfmmm_writer_create() { return new AsyncWriter(); }

void bfmmm_writer_submit(void* handle, const char* path, const double* data,
                         long rows, long cols, long slices) {
  auto* w = static_cast<AsyncWriter*>(handle);
  WriteJob job;
  job.path = path;
  job.data.assign(data, data + static_cast<size_t>(rows) * cols
                                   * (slices ? slices : 1));
  job.rows = rows; job.cols = cols; job.slices = slices;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->queue.push_back(std::move(job));
  }
  w->cv.notify_one();
}

// Blocks until the queue drains.  Returns number of failed writes.
long bfmmm_writer_flush(void* handle) {
  auto* w = static_cast<AsyncWriter*>(handle);
  for (;;) {
    {
      std::lock_guard<std::mutex> lk(w->mu);
      if (w->queue.empty()) break;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  return w->failed.load();
}

long bfmmm_writer_completed(void* handle) {
  return static_cast<AsyncWriter*>(handle)->completed.load();
}

void bfmmm_writer_destroy(void* handle) {
  bfmmm_writer_flush(handle);
  delete static_cast<AsyncWriter*>(handle);
}

}  // extern "C"
