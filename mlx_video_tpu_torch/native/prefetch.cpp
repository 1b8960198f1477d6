// Threaded file prefetcher for the training data path, and the readahead
// hint of the weight readers.
//
// The port's copy of mlx_video_tpu/native/prefetch.cpp (the same C ABI and
// behaviour). A fixed thread pool preads whole files into malloc'd buffers
// while the current training step runs on the card, so the next batch's file
// IO overlaps it.
//
// C ABI (consumed via ctypes from mlx_video_tpu_torch/io/prefetch.py):
//   pf_create(num_threads)                 -> pool handle
//   pf_submit(pool, path)                  -> ticket id (enqueue read)
//   pf_wait(pool, ticket, &data, &size)    -> 0 ok / <0 errno-style failure
//   pf_release(pool, ticket)               -> free the buffer
//   pf_destroy(pool)
//   pf_advise(path)                        -> posix_fadvise(WILLNEED) the file
//
// Buffers stay owned by the pool until pf_release; Python copies them
// (ctypes) before releasing.

#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct Task {
    int64_t id;
    std::string path;
};

struct Result {
    uint8_t* data = nullptr;
    uint64_t size = 0;
    int error = 0;  // 0 ok, else -errno
    bool done = false;
};

struct Pool {
    std::vector<std::thread> workers;
    std::deque<Task> queue;
    std::unordered_map<int64_t, Result> results;
    std::mutex mu;
    std::condition_variable queue_cv;   // workers wait for tasks
    std::condition_variable done_cv;    // waiters wait for results
    int64_t next_id = 1;
    bool stopping = false;

    void worker() {
        for (;;) {
            Task task;
            {
                std::unique_lock<std::mutex> lock(mu);
                queue_cv.wait(lock, [&] { return stopping || !queue.empty(); });
                if (stopping && queue.empty()) return;
                task = std::move(queue.front());
                queue.pop_front();
            }
            Result res = read_file(task.path);
            {
                std::lock_guard<std::mutex> lock(mu);
                res.done = true;
                results[task.id] = res;
            }
            done_cv.notify_all();
        }
    }

    static Result read_file(const std::string& path) {
        Result res;
        int fd = ::open(path.c_str(), O_RDONLY);
        if (fd < 0) {
            res.error = -errno;
            return res;
        }
        struct stat st;
        if (::fstat(fd, &st) != 0) {
            res.error = -errno;
            ::close(fd);
            return res;
        }
#ifdef POSIX_FADV_SEQUENTIAL
        ::posix_fadvise(fd, 0, st.st_size, POSIX_FADV_SEQUENTIAL);
#endif
        uint64_t size = static_cast<uint64_t>(st.st_size);
        uint8_t* buf = static_cast<uint8_t*>(std::malloc(size ? size : 1));
        if (buf == nullptr) {
            res.error = -ENOMEM;
            ::close(fd);
            return res;
        }
        uint64_t off = 0;
        while (off < size) {
            ssize_t n = ::pread(fd, buf + off, size - off, static_cast<off_t>(off));
            if (n < 0) {
                if (errno == EINTR) continue;
                res.error = -errno;
                std::free(buf);
                ::close(fd);
                return res;
            }
            if (n == 0) break;  // truncated under us; return what we have
            off += static_cast<uint64_t>(n);
        }
        ::close(fd);
        res.data = buf;
        res.size = off;
        return res;
    }
};

}  // namespace

extern "C" {

void* pf_create(int num_threads) {
    if (num_threads < 1) num_threads = 1;
    Pool* pool = new Pool();
    for (int i = 0; i < num_threads; ++i) {
        pool->workers.emplace_back([pool] { pool->worker(); });
    }
    return pool;
}

int64_t pf_submit(void* handle, const char* path) {
    Pool* pool = static_cast<Pool*>(handle);
    int64_t id;
    {
        std::lock_guard<std::mutex> lock(pool->mu);
        id = pool->next_id++;
        pool->queue.push_back(Task{id, std::string(path)});
    }
    pool->queue_cv.notify_one();
    return id;
}

int pf_wait(void* handle, int64_t ticket, uint8_t** data, uint64_t* size) {
    Pool* pool = static_cast<Pool*>(handle);
    std::unique_lock<std::mutex> lock(pool->mu);
    pool->done_cv.wait(lock, [&] {
        auto it = pool->results.find(ticket);
        return it != pool->results.end() && it->second.done;
    });
    Result& res = pool->results[ticket];
    if (res.error != 0) {
        int err = res.error;
        pool->results.erase(ticket);
        return err;
    }
    *data = res.data;
    *size = res.size;
    return 0;
}

void pf_release(void* handle, int64_t ticket) {
    Pool* pool = static_cast<Pool*>(handle);
    std::lock_guard<std::mutex> lock(pool->mu);
    auto it = pool->results.find(ticket);
    if (it != pool->results.end()) {
        std::free(it->second.data);
        pool->results.erase(it);
    }
}

void pf_destroy(void* handle) {
    Pool* pool = static_cast<Pool*>(handle);
    {
        std::lock_guard<std::mutex> lock(pool->mu);
        pool->stopping = true;
    }
    pool->queue_cv.notify_all();
    for (auto& t : pool->workers) t.join();
    // free any unclaimed buffers
    for (auto& kv : pool->results) std::free(kv.second.data);
    delete pool;
}

int pf_advise(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return -errno;
#ifdef POSIX_FADV_WILLNEED
    struct stat st;
    if (::fstat(fd, &st) == 0) {
        ::posix_fadvise(fd, 0, st.st_size, POSIX_FADV_WILLNEED);
    }
#endif
    ::close(fd);
    return 0;
}

}  // extern "C"
