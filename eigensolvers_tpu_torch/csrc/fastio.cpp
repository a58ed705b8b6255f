// fastio — asynchronous buffered file writer for checkpoint streams.
//
// Role: the native runtime component of the checkpoint path.  Krylov-basis
// checkpoints (utils/checkpointing.py) can be multi-GB at production sizes;
// blocking the solver loop on disk writes wastes accelerator time.  This
// library owns a worker thread draining a bounded queue of (path, bytes)
// jobs so the Python side enqueues a snapshot and returns to the solve
// immediately (orbax-style async saves without the dependency).
//
// C API (ctypes-friendly, no C++ types across the boundary):
//   void* fio_create(int max_queue);            // NULL on failure
//   int   fio_submit(void*, const char* path,
//                    const void* data, long n); // copies data; 0 on success
//   int   fio_pending(void*);                   // jobs not yet completed
//   int   fio_flush(void*);                     // block until drained; #errors
//   int   fio_error_count(void*);               // cumulative write errors
//   void  fio_destroy(void*);                   // flush + join + free
//
// Build: g++ -O2 -shared -fPIC -pthread fastio.cpp -o libfastio.so

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Job {
    std::string path;
    std::vector<char> bytes;
};

class Writer {
  public:
    explicit Writer(int max_queue)
        : max_queue_(max_queue > 0 ? max_queue : 16), stop_(false),
          in_flight_(0), errors_(0) {
        worker_ = std::thread([this] { this->run(); });
    }

    ~Writer() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            stop_ = true;
            cv_.notify_all();
        }
        if (worker_.joinable()) worker_.join();
    }

    int submit(const char* path, const void* data, long n) {
        if (path == nullptr || (data == nullptr && n > 0) || n < 0) return 1;
        Job job;
        job.path = path;
        job.bytes.resize(static_cast<size_t>(n));
        if (n > 0) std::memcpy(job.bytes.data(), data, static_cast<size_t>(n));
        std::unique_lock<std::mutex> lk(mu_);
        // bounded queue: apply backpressure instead of unbounded memory
        cv_space_.wait(lk, [this] {
            return queue_.size() < static_cast<size_t>(max_queue_) || stop_;
        });
        if (stop_) return 2;
        queue_.push_back(std::move(job));
        in_flight_.fetch_add(1);
        cv_.notify_one();
        return 0;
    }

    int pending() const { return in_flight_.load(); }

    int flush() {
        std::unique_lock<std::mutex> lk(mu_);
        cv_done_.wait(lk, [this] { return in_flight_.load() == 0; });
        return errors_.load();
    }

    int error_count() const { return errors_.load(); }

  private:
    void run() {
        for (;;) {
            Job job;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
                if (queue_.empty()) {
                    if (stop_) return;
                    continue;
                }
                job = std::move(queue_.front());
                queue_.pop_front();
                cv_space_.notify_one();
            }
            if (!write_file(job)) errors_.fetch_add(1);
            if (in_flight_.fetch_sub(1) == 1) cv_done_.notify_all();
        }
    }

    static bool write_file(const Job& job) {
        const std::string tmp = job.path + ".tmp";
        std::FILE* f = std::fopen(tmp.c_str(), "wb");
        if (f == nullptr) return false;
        bool ok = true;
        if (!job.bytes.empty()) {
            ok = std::fwrite(job.bytes.data(), 1, job.bytes.size(), f) ==
                 job.bytes.size();
        }
        ok = (std::fclose(f) == 0) && ok;
        if (ok) ok = (std::rename(tmp.c_str(), job.path.c_str()) == 0);
        if (!ok) std::remove(tmp.c_str());
        return ok;
    }

    const int max_queue_;
    bool stop_;
    std::deque<Job> queue_;
    std::mutex mu_;
    std::condition_variable cv_;
    std::condition_variable cv_space_;
    std::condition_variable cv_done_;
    std::thread worker_;
    std::atomic<int> in_flight_;
    std::atomic<int> errors_;
};

}  // namespace

extern "C" {

void* fio_create(int max_queue) {
    try {
        return new Writer(max_queue);
    } catch (...) {
        return nullptr;
    }
}

int fio_submit(void* h, const char* path, const void* data, long n) {
    if (h == nullptr) return 1;
    return static_cast<Writer*>(h)->submit(path, data, n);
}

int fio_pending(void* h) {
    if (h == nullptr) return 0;
    return static_cast<Writer*>(h)->pending();
}

int fio_flush(void* h) {
    if (h == nullptr) return 0;
    return static_cast<Writer*>(h)->flush();
}

int fio_error_count(void* h) {
    if (h == nullptr) return 0;
    return static_cast<Writer*>(h)->error_count();
}

void fio_destroy(void* h) {
    delete static_cast<Writer*>(h);
}

}  // extern "C"
