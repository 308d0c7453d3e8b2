// Asynchronous file I/O engine for the NVMe offload tier.
//
// Reference analog: csrc/aio (DeepNVMe) — a libaio worker-thread pool with
// work/complete queues (deepspeed_aio_thread.h:20) feeding pinned host
// buffers. Rebuilt TPU-side: a portable POSIX thread pool issuing pread/pwrite
// on per-thread file descriptors (libaio is not guaranteed in this image;
// threaded psync saturates modern NVMe at queue depth = num_threads), with a
// C ABI for ctypes. Buffers are caller-owned (numpy arrays pinned by the
// Python layer); completion is polled or waited via condition variable.

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

struct Request {
    int64_t id;
    bool write;
    std::string path;
    void* buffer;
    int64_t nbytes;
    int64_t file_offset;
};

struct Engine {
    std::vector<std::thread> workers;
    std::deque<Request> queue;
    std::mutex mu;
    std::condition_variable cv_work;
    std::condition_variable cv_done;
    std::atomic<int64_t> next_id{1};
    // completed, not-yet-waited requests: id -> ok. Per-request status (not a
    // global sticky counter) so one failed swap never poisons later waits.
    std::unordered_map<int64_t, bool> done;
    int64_t outstanding = 0;              // submitted but not completed
    bool shutdown = false;
    int block_size = 1 << 20;             // 1 MiB pread/pwrite chunks

    explicit Engine(int num_threads) {
        for (int i = 0; i < num_threads; ++i)
            workers.emplace_back([this] { run(); });
    }

    ~Engine() {
        {
            std::lock_guard<std::mutex> l(mu);
            shutdown = true;
        }
        cv_work.notify_all();
        for (auto& t : workers) t.join();
    }

    void run() {
        for (;;) {
            Request req;
            {
                std::unique_lock<std::mutex> l(mu);
                cv_work.wait(l, [this] { return shutdown || !queue.empty(); });
                if (shutdown && queue.empty()) return;
                req = queue.front();
                queue.pop_front();
            }
            bool ok = execute(req);
            {
                std::lock_guard<std::mutex> l(mu);
                done[req.id] = ok;
                outstanding--;
            }
            cv_done.notify_all();
        }
    }

    bool execute(const Request& req) {
        int flags = req.write ? (O_WRONLY | O_CREAT) : O_RDONLY;
        int fd = ::open(req.path.c_str(), flags, 0644);
        if (fd < 0) return false;
        char* p = (char*)req.buffer;
        int64_t remaining = req.nbytes;
        int64_t off = req.file_offset;
        bool ok = true;
        while (remaining > 0) {
            int64_t chunk = remaining < block_size ? remaining : block_size;
            ssize_t r = req.write ? ::pwrite(fd, p, chunk, off)
                                  : ::pread(fd, p, chunk, off);
            if (r <= 0) { ok = false; break; }
            p += r; off += r; remaining -= r;
        }
        ::close(fd);
        return ok;
    }

    int64_t submit(bool write, const char* path, void* buf, int64_t nbytes,
                   int64_t offset) {
        int64_t id = next_id.fetch_add(1);
        {
            std::lock_guard<std::mutex> l(mu);
            queue.push_back({id, write, path, buf, nbytes, offset});
            outstanding++;
        }
        cv_work.notify_one();
        return id;
    }

    bool is_done(int64_t id) {
        std::lock_guard<std::mutex> l(mu);
        return done.count(id) != 0;
    }

    // 0 = success, 1 = this request failed (entry reclaimed either way so the
    // table stays bounded over long runs).
    int wait(int64_t id) {
        std::unique_lock<std::mutex> l(mu);
        cv_done.wait(l, [&] { return done.count(id) != 0; });
        bool ok = done[id];
        done.erase(id);
        return ok ? 0 : 1;
    }

    // Waits for all outstanding requests; returns how many of the completed,
    // not-individually-waited requests failed, then clears the table.
    int drain() {
        std::unique_lock<std::mutex> l(mu);
        cv_done.wait(l, [&] { return outstanding == 0; });
        int failures = 0;
        for (auto& kv : done) if (!kv.second) failures++;
        done.clear();
        return failures;
    }
};

}  // namespace

extern "C" {

void* aio_create(int num_threads) { return new Engine(num_threads); }
void aio_destroy(void* h) { delete (Engine*)h; }

int64_t aio_pwrite(void* h, const char* path, void* buf, int64_t nbytes,
                   int64_t offset) {
    return ((Engine*)h)->submit(true, path, buf, nbytes, offset);
}

int64_t aio_pread(void* h, const char* path, void* buf, int64_t nbytes,
                  int64_t offset) {
    return ((Engine*)h)->submit(false, path, buf, nbytes, offset);
}

int aio_is_done(void* h, int64_t id) { return ((Engine*)h)->is_done(id) ? 1 : 0; }
int aio_wait(void* h, int64_t id) { return ((Engine*)h)->wait(id); }
int aio_drain(void* h) { return ((Engine*)h)->drain(); }

}  // extern "C"
