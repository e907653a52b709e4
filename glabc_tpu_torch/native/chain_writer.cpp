// Native asynchronous chain-history sink.
//
// The reference's "checkpointing" is synchronous Python csv.writer flushes
// every 10k iterations (GLMCMC.py:105-111) — at multi-million transitions/s
// the Python formatter becomes the pipeline bottleneck (~3-5s per 1e6 rows).
// This writer moves formatting + IO off the critical path: the device loop
// hands (steps x dim) float blocks to cw_write(), which enqueues a copy and
// returns immediately; a background thread formats (CSV text or raw
// float32 binary) and appends to the file.
//
// C ABI (used from Python via ctypes — no pybind11 in this image):
//   handle = cw_open(path, dim, binary)
//   cw_write(handle, data, steps)     // data: steps*dim float32, row-major
//   cw_flush(handle)                  // block until queue drained
//   cw_close(handle)                  // flush + join + fclose
//   cw_queue_depth(handle)            // blocks currently queued
//
// Build: glabc_tpu_torch/native/writer.py runs
//   g++ -O3 -shared -fPIC -std=c++17 -o <tmp> chain_writer.cpp -lpthread
// at first use and renames the library into glabc_tpu_torch/_build/.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Block {
  std::vector<float> data;
  int64_t steps;
};

class ChainWriter {
 public:
  ChainWriter(const char* path, int64_t dim, bool binary)
      : dim_(dim), binary_(binary), file_(std::fopen(path, "ab")) {
    if (file_ != nullptr) {
      worker_ = std::thread([this] { Run(); });
    }
  }

  ~ChainWriter() { Close(); }

  bool ok() const { return file_ != nullptr; }

  void Write(const float* data, int64_t steps) {
    Block b;
    b.steps = steps;
    b.data.assign(data, data + steps * dim_);
    {
      std::lock_guard<std::mutex> lock(mu_);
      queue_.push_back(std::move(b));
    }
    cv_.notify_one();
  }

  void Flush() {
    std::unique_lock<std::mutex> lock(mu_);
    drained_.wait(lock, [this] { return queue_.empty() && !writing_; });
    std::fflush(file_);
  }

  void Close() {
    if (file_ == nullptr) return;
    {
      std::lock_guard<std::mutex> lock(mu_);
      done_ = true;
    }
    cv_.notify_one();
    if (worker_.joinable()) worker_.join();
    std::fclose(file_);
    file_ = nullptr;
  }

  int64_t QueueDepth() {
    std::lock_guard<std::mutex> lock(mu_);
    return static_cast<int64_t>(queue_.size()) + (writing_ ? 1 : 0);
  }

 private:
  void Run() {
    // one reusable text buffer; %.9g round-trips float32 exactly
    std::vector<char> line(32 * dim_ + 2);
    for (;;) {
      Block b;
      {
        std::unique_lock<std::mutex> lock(mu_);
        cv_.wait(lock, [this] { return done_ || !queue_.empty(); });
        if (queue_.empty()) {
          if (done_) return;
          continue;
        }
        b = std::move(queue_.front());
        queue_.pop_front();
        writing_ = true;
      }
      if (binary_) {
        std::fwrite(b.data.data(), sizeof(float), b.data.size(), file_);
      } else {
        for (int64_t s = 0; s < b.steps; ++s) {
          char* p = line.data();
          const float* row = b.data.data() + s * dim_;
          for (int64_t j = 0; j < dim_; ++j) {
            if (j) *p++ = ',';
            p += std::snprintf(p, 32, "%.9g", static_cast<double>(row[j]));
          }
          *p++ = '\n';
          std::fwrite(line.data(), 1, p - line.data(), file_);
        }
      }
      {
        std::lock_guard<std::mutex> lock(mu_);
        writing_ = false;
        if (queue_.empty()) drained_.notify_all();
      }
    }
  }

  const int64_t dim_;
  const bool binary_;
  std::FILE* file_;
  std::thread worker_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable drained_;
  std::deque<Block> queue_;
  bool done_ = false;
  bool writing_ = false;
};

std::mutex g_mu;
std::unordered_map<int64_t, std::unique_ptr<ChainWriter>> g_writers;
int64_t g_next = 1;

}  // namespace

extern "C" {

int64_t cw_open(const char* path, int64_t dim, int32_t binary) {
  auto w = std::make_unique<ChainWriter>(path, dim, binary != 0);
  if (!w->ok()) return -1;
  std::lock_guard<std::mutex> lock(g_mu);
  int64_t h = g_next++;
  g_writers[h] = std::move(w);
  return h;
}

int32_t cw_write(int64_t handle, const float* data, int64_t steps) {
  ChainWriter* w;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_writers.find(handle);
    if (it == g_writers.end()) return -1;
    w = it->second.get();
  }
  w->Write(data, steps);
  return 0;
}

int32_t cw_flush(int64_t handle) {
  ChainWriter* w;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_writers.find(handle);
    if (it == g_writers.end()) return -1;
    w = it->second.get();
  }
  w->Flush();
  return 0;
}

int64_t cw_queue_depth(int64_t handle) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_writers.find(handle);
  if (it == g_writers.end()) return -1;
  return it->second->QueueDepth();
}

int32_t cw_close(int64_t handle) {
  std::unique_ptr<ChainWriter> w;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_writers.find(handle);
    if (it == g_writers.end()) return -1;
    w = std::move(it->second);
    g_writers.erase(it);
  }
  w->Close();
  return 0;
}

}  // extern "C"
