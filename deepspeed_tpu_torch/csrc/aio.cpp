// Async tensor I/O engine for NVMe offload (ZeRO-Infinity tier).
//
// The port's copy of deepspeed_tpu/csrc/aio.cpp, the counterpart of the
// reference's libaio stack (csrc/aio/common/deepspeed_aio_common.cpp:338,
// py_lib/deepspeed_py_aio_handle.cpp:298, deepspeed_aio_thread.cpp): a pool
// of worker threads services pread/pwrite requests split into block_size
// chunks against O_DIRECT-less fds. It needs no libaio or liburing: a
// thread pool over positioned I/O gives the same overlap of disk latency
// with device compute, which is what the swap pipeline needs. Host code
// only, built with g++ (ops/op_builder.py); plain C ABI for ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Request {
    bool is_read;
    std::string path;
    char* buffer;
    int64_t num_bytes;
    int64_t file_offset;
};

struct AioHandle {
    int64_t block_size;
    int n_threads;
    std::vector<std::thread> workers;
    std::deque<Request> queue;
    std::mutex mu;
    std::condition_variable cv;
    std::atomic<int64_t> inflight{0};
    std::atomic<int64_t> errors{0};
    std::condition_variable done_cv;
    bool shutdown = false;

    void worker() {
        for (;;) {
            Request req;
            {
                std::unique_lock<std::mutex> lock(mu);
                cv.wait(lock, [&] { return shutdown || !queue.empty(); });
                if (shutdown && queue.empty()) return;
                req = std::move(queue.front());
                queue.pop_front();
            }
            if (!run_one(req)) errors.fetch_add(1);
            if (inflight.fetch_sub(1) == 1) {
                std::lock_guard<std::mutex> lock(mu);
                done_cv.notify_all();
            }
        }
    }

    bool run_one(const Request& req) {
        int flags = req.is_read ? O_RDONLY : (O_WRONLY | O_CREAT);
        int fd = open(req.path.c_str(), flags, 0644);
        if (fd < 0) return false;
        int64_t done = 0;
        bool ok = true;
        while (done < req.num_bytes) {
            int64_t chunk = std::min(block_size, req.num_bytes - done);
            ssize_t r = req.is_read
                ? pread(fd, req.buffer + done, chunk, req.file_offset + done)
                : pwrite(fd, req.buffer + done, chunk, req.file_offset + done);
            if (r <= 0) { ok = false; break; }
            done += r;
        }
        close(fd);
        return ok;
    }
};

}  // namespace

extern "C" {

void* ds_aio_new(int64_t block_size, int n_threads) {
    auto* h = new AioHandle();
    h->block_size = block_size > 0 ? block_size : (1 << 20);
    h->n_threads = n_threads > 0 ? n_threads : 1;
    for (int i = 0; i < h->n_threads; ++i)
        h->workers.emplace_back([h] { h->worker(); });
    return h;
}

void ds_aio_free(void* handle) {
    auto* h = static_cast<AioHandle*>(handle);
    {
        std::lock_guard<std::mutex> lock(h->mu);
        h->shutdown = true;
    }
    h->cv.notify_all();
    for (auto& t : h->workers) t.join();
    delete h;
}

// Enqueue; returns immediately. Buffer must stay alive until ds_aio_wait.
void ds_aio_pread(void* handle, const char* path, char* buffer,
                  int64_t num_bytes, int64_t file_offset) {
    auto* h = static_cast<AioHandle*>(handle);
    h->inflight.fetch_add(1);
    {
        std::lock_guard<std::mutex> lock(h->mu);
        h->queue.push_back(Request{true, path, buffer, num_bytes, file_offset});
    }
    h->cv.notify_one();
}

void ds_aio_pwrite(void* handle, const char* path, char* buffer,
                   int64_t num_bytes, int64_t file_offset) {
    auto* h = static_cast<AioHandle*>(handle);
    h->inflight.fetch_add(1);
    {
        std::lock_guard<std::mutex> lock(h->mu);
        h->queue.push_back(Request{false, path, buffer, num_bytes, file_offset});
    }
    h->cv.notify_one();
}

// Block until all queued ops complete; returns number of failed ops since
// the last wait (0 == success).
int64_t ds_aio_wait(void* handle) {
    auto* h = static_cast<AioHandle*>(handle);
    std::unique_lock<std::mutex> lock(h->mu);
    h->done_cv.wait(lock, [&] { return h->inflight.load() == 0; });
    return h->errors.exchange(0);
}

int64_t ds_aio_inflight(void* handle) {
    return static_cast<AioHandle*>(handle)->inflight.load();
}

}  // extern "C"
