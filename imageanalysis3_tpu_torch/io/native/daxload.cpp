// Native .dax loader: fused read + de-interleave.
//
// The reference reads the whole interleaved movie into one buffer and
// slices channels out of it in NumPy (io_tools/load.py:471-550).  At
// production scale (1.6 GB/FOV) that costs two passes over the bytes
// (read, then strided copy) on one thread.  Here each worker thread
// pread()s one (channel, z-plane) frame from the file STRAIGHT into its
// final slot in the per-channel output block — one pass, no staging
// movie, parallel across frames (page-cache hits scale with threads;
// cold reads overlap I/O).  dax_split_channels is the in-memory variant
// (parallel memcpy fan-out) for movies already resident.
//
// Frames are raw little/big-endian uint16 bytes; byte order is the
// caller's concern (numpy view / byteswap on the assembled block).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// fan k = 0..total-1 over nt threads via an atomic work counter
template <typename Fn>
int fan_out(int64_t total, int nt, Fn fn) {
    std::atomic<int64_t> next(0);
    std::atomic<int> err(0);
    auto work = [&]() {
        for (;;) {
            int64_t k = next.fetch_add(1, std::memory_order_relaxed);
            if (k >= total || err.load(std::memory_order_relaxed)) break;
            int e = fn(k);
            if (e) err.store(e, std::memory_order_relaxed);
        }
    };
    if (nt <= 1) {
        work();
    } else {
        std::vector<std::thread> ts;
        ts.reserve(nt);
        for (int i = 0; i < nt; ++i) ts.emplace_back(work);
        for (auto &t : ts) t.join();
    }
    return err.load();
}

}  // namespace

extern "C" {

// Read n_ch de-interleaved channels of n_z planes each from the .dax
// file at `path` into `out` (n_ch, n_z, frame_bytes) contiguous bytes.
// starts[c] = first frame index of channel c; `stride` = frames between
// consecutive planes of one channel (= number of interleaved colors).
// Returns 0 on success, -1 open failure, -2 short/failed read.
int dax_load_channels(const char *path, int64_t frame_bytes,
                      const int64_t *starts, int64_t n_ch, int64_t stride,
                      int64_t n_z, uint8_t *out, int n_threads) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    int err = fan_out(n_ch * n_z, n_threads, [&](int64_t k) -> int {
        int64_t c = k / n_z, z = k % n_z;
        int64_t src = starts[c] + z * stride;
        off_t off = (off_t)src * (off_t)frame_bytes;
        uint8_t *dst = out + (size_t)k * (size_t)frame_bytes;
        int64_t done = 0;
        while (done < frame_bytes) {
            ssize_t r = pread(fd, dst + done, (size_t)(frame_bytes - done),
                              off + (off_t)done);
            if (r <= 0) return -2;
            done += r;
        }
        return 0;
    });
    close(fd);
    return err;
}

// In-memory variant: de-interleave `movie` (n_frames, frame_bytes) into
// `out` (n_ch, n_z, frame_bytes) with a parallel memcpy fan-out.
void dax_split_channels(const uint8_t *movie, int64_t frame_bytes,
                        const int64_t *starts, int64_t n_ch, int64_t stride,
                        int64_t n_z, uint8_t *out, int n_threads) {
    fan_out(n_ch * n_z, n_threads, [&](int64_t k) -> int {
        int64_t c = k / n_z, z = k % n_z;
        const uint8_t *src =
            movie + (size_t)(starts[c] + z * stride) * (size_t)frame_bytes;
        std::memcpy(out + (size_t)k * (size_t)frame_bytes, src,
                    (size_t)frame_bytes);
        return 0;
    });
}

}  // extern "C"
