// Native serving runtime: batching queue, rate limiter, latency histogram.
//
// Exposed over a C ABI for ctypes (no pybind11):
//
//  - BatchQueue: mutex+condvar MPMC ring buffer whose consumer pops an
//    aggregated batch (up to max_batch) in one wait: the request-
//    coalescing core of the serving layer, with no polling.
//  - RateLimiter: per-key sliding-window counters behind a striped lock.
//  - LatencyHistogram: fixed log-spaced bins, lock-free recording via
//    atomics, percentile queries (p50/p95/p99 of detector.benchmark).
//
// Built on first use by iqc_tpu_torch/runtime/native.py (one g++ call) into
// build/runtime/ under the repository root.

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

double now_seconds() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------------------
// BatchQueue
// ---------------------------------------------------------------------------

struct BatchQueue {
  explicit BatchQueue(size_t capacity) : capacity_(capacity) {}

  // returns false if full (backpressure) or closed
  bool push(int64_t id) {
    std::unique_lock<std::mutex> lock(mu_);
    if (closed_ || items_.size() >= capacity_) return false;
    items_.push_back(id);
    lock.unlock();
    cv_.notify_one();
    return true;
  }

  // pop up to max_batch ids; waits up to timeout_ms for the first item,
  // then greedily drains whatever else is queued. Returns count.
  int pop_batch(int64_t* out, int max_batch, double timeout_ms) {
    std::unique_lock<std::mutex> lock(mu_);
    if (items_.empty()) {
      cv_.wait_for(lock, std::chrono::duration<double, std::milli>(timeout_ms),
                   [&] { return !items_.empty() || closed_; });
    }
    int n = 0;
    while (!items_.empty() && n < max_batch) {
      out[n++] = items_.front();
      items_.pop_front();
    }
    return n;
  }

  size_t size() {
    std::lock_guard<std::mutex> lock(mu_);
    return items_.size();
  }

  void close() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      closed_ = true;
    }
    cv_.notify_all();
  }

  size_t capacity_;
  std::deque<int64_t> items_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool closed_ = false;
};

// ---------------------------------------------------------------------------
// RateLimiter: sliding window per key, striped locking
// ---------------------------------------------------------------------------

struct RateLimiter {
  RateLimiter(int max_requests, double window_s)
      : max_requests_(max_requests), window_s_(window_s) {}

  static constexpr int kStripes = 16;

  bool allow(const std::string& key) {
    double now = now_seconds();
    size_t stripe = std::hash<std::string>{}(key) % kStripes;
    std::lock_guard<std::mutex> lock(mu_[stripe]);
    auto& hist = history_[stripe][key];
    while (!hist.empty() && now - hist.front() >= window_s_) hist.pop_front();
    if (static_cast<int>(hist.size()) >= max_requests_) return false;
    hist.push_back(now);
    return true;
  }

  int max_requests_;
  double window_s_;
  std::mutex mu_[kStripes];
  std::unordered_map<std::string, std::deque<double>> history_[kStripes];
};

// ---------------------------------------------------------------------------
// LatencyHistogram: log-spaced bins 10us..100s, atomic counters
// ---------------------------------------------------------------------------

struct LatencyHistogram {
  static constexpr int kBins = 256;
  static constexpr double kMinMs = 0.01;   // 10 us
  static constexpr double kMaxMs = 1e5;    // 100 s

  LatencyHistogram() {
    for (auto& b : bins_) b.store(0, std::memory_order_relaxed);
    count_.store(0);
    sum_ms_.store(0.0);
  }

  static int bin_index(double ms) {
    if (ms <= kMinMs) return 0;
    if (ms >= kMaxMs) return kBins - 1;
    double t = std::log(ms / kMinMs) / std::log(kMaxMs / kMinMs);
    int i = static_cast<int>(t * (kBins - 1));
    return i < 0 ? 0 : (i >= kBins ? kBins - 1 : i);
  }

  static double bin_value(int i) {
    double t = static_cast<double>(i) / (kBins - 1);
    return kMinMs * std::pow(kMaxMs / kMinMs, t);
  }

  void record(double ms) {
    bins_[bin_index(ms)].fetch_add(1, std::memory_order_relaxed);
    count_.fetch_add(1, std::memory_order_relaxed);
    double prev = sum_ms_.load(std::memory_order_relaxed);
    while (!sum_ms_.compare_exchange_weak(prev, prev + ms)) {
    }
  }

  double percentile(double p) {
    uint64_t total = count_.load(std::memory_order_relaxed);
    if (total == 0) return 0.0;
    uint64_t target = static_cast<uint64_t>(p / 100.0 * (total - 1)) + 1;
    uint64_t seen = 0;
    for (int i = 0; i < kBins; ++i) {
      seen += bins_[i].load(std::memory_order_relaxed);
      if (seen >= target) return bin_value(i);
    }
    return bin_value(kBins - 1);
  }

  std::atomic<uint64_t> bins_[kBins];
  std::atomic<uint64_t> count_;
  std::atomic<double> sum_ms_;
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* bq_create(size_t capacity) { return new BatchQueue(capacity); }
void bq_destroy(void* q) { delete static_cast<BatchQueue*>(q); }
int bq_push(void* q, int64_t id) {
  return static_cast<BatchQueue*>(q)->push(id) ? 1 : 0;
}
int bq_pop_batch(void* q, int64_t* out, int max_batch, double timeout_ms) {
  return static_cast<BatchQueue*>(q)->pop_batch(out, max_batch, timeout_ms);
}
size_t bq_size(void* q) { return static_cast<BatchQueue*>(q)->size(); }
void bq_close(void* q) { static_cast<BatchQueue*>(q)->close(); }

void* rl_create(int max_requests, double window_s) {
  return new RateLimiter(max_requests, window_s);
}
void rl_destroy(void* r) { delete static_cast<RateLimiter*>(r); }
int rl_allow(void* r, const char* key) {
  return static_cast<RateLimiter*>(r)->allow(key) ? 1 : 0;
}

void* lh_create() { return new LatencyHistogram(); }
void lh_destroy(void* h) { delete static_cast<LatencyHistogram*>(h); }
void lh_record(void* h, double ms) {
  static_cast<LatencyHistogram*>(h)->record(ms);
}
double lh_percentile(void* h, double p) {
  return static_cast<LatencyHistogram*>(h)->percentile(p);
}
uint64_t lh_count(void* h) {
  return static_cast<LatencyHistogram*>(h)->count_.load();
}
double lh_mean(void* h) {
  auto* hist = static_cast<LatencyHistogram*>(h);
  uint64_t n = hist->count_.load();
  return n ? hist->sum_ms_.load() / n : 0.0;
}

}  // extern "C"
