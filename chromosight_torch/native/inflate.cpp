// Deflate-filtered chunks for the HDF5 reader (chromosight_torch/io/hdf5.py):
// the chunks of one slice inflated with zlib (HDF5's deflate filter stores
// each chunk as one zlib stream) and unshuffled (shuffle.cpp's
// hdf5_unshuffle) straight into their rows of the output, on a few
// threads of its own, so that a slice of thousands of chunks is one call
// that never holds the Python interpreter lock.  Built with g++ at first
// use together with shuffle.cpp, and linked with -lz.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" void hdf5_unshuffle(const uint8_t* in, int64_t n_bytes, int64_t size, uint8_t* out);

extern "C" {

// Chunk i is in_len[i] bytes at in + in_off[i]; it must inflate to exactly
// chunk_bytes bytes, which go to out + out_off[i], unshuffled by elements
// of `element` bytes first when element > 1.  Runs on `threads` threads.
// Returns -1 when every chunk decoded, else the index of a chunk that did
// not (a zlib error, or another size than chunk_bytes).
int64_t hdf5_inflate_chunks(const uint8_t* in, const int64_t* in_off, const int64_t* in_len,
                            int64_t n, uint8_t* out, const int64_t* out_off,
                            int64_t chunk_bytes, int64_t element, int64_t threads) {
    std::atomic<int64_t> next{0};
    std::atomic<int64_t> failed{-1};
    auto work = [&]() {
        std::vector<uint8_t> scratch(element > 1 ? chunk_bytes : 0);
        for (int64_t i = next++; i < n && failed.load() < 0; i = next++) {
            uint8_t* dst = element > 1 ? scratch.data() : out + out_off[i];
            uLongf got = static_cast<uLongf>(chunk_bytes);
            const int rc = uncompress(dst, &got, in + in_off[i], static_cast<uLong>(in_len[i]));
            if (rc != Z_OK || static_cast<int64_t>(got) != chunk_bytes) {
                int64_t none = -1;
                failed.compare_exchange_strong(none, i);
                return;
            }
            if (element > 1) hdf5_unshuffle(dst, chunk_bytes, element, out + out_off[i]);
        }
    };
    const int64_t t = std::max<int64_t>(1, std::min(threads, n));
    std::vector<std::thread> pool;
    for (int64_t k = 1; k < t; ++k) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
    return failed.load();
}

}  // extern "C"
