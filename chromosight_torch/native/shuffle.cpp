// HDF5's shuffle filter (filter 2) for the HDF5 reader and writer
// (chromosight_torch/io/hdf5.py): a chunk of n elements of `size` bytes is
// stored shuffled as byte 0 of every element, then byte 1 of every
// element, and so on; the bytes past the last whole element stay where
// they are.  Built with g++ at first use, as lzf.cpp is.

#include <cstdint>
#include <cstring>

namespace {

// Elements of S bytes, S known at compile time: element i gathers byte j
// from stream j as an integer of S bytes (little-endian hosts), a loop the
// compiler vectorizes.
// (``stride``: the length of a stream, n unless this is a tail)
template <typename T>
void unshuffle_fixed(const uint8_t* in, int64_t n, uint8_t* out, int64_t stride) {
    constexpr int S = sizeof(T);
    for (int64_t i = 0; i < n; ++i) {
        T v = 0;
        for (int j = 0; j < S; ++j) v |= T(in[j * stride + i]) << (8 * j);
        std::memcpy(out + i * S, &v, S);
    }
}

template <typename T>
void shuffle_fixed(const uint8_t* in, int64_t n, uint8_t* out, int64_t stride) {
    constexpr int S = sizeof(T);
    for (int64_t i = 0; i < n; ++i) {
        T v;
        std::memcpy(&v, in + i * S, S);
        for (int j = 0; j < S; ++j) out[j * stride + i] = uint8_t(v >> (8 * j));
    }
}

// Elements of 8 bytes: blocks of 8 elements, each an 8 x 8 byte
// transpose of 8 words (one from each stream, or one per element) in three
// rounds of block swaps; the transpose is its own inverse.
inline void transpose8x8(uint64_t x[8]) {
    for (int j = 0; j < 8; j += 2) {
        const uint64_t t = ((x[j] >> 8) ^ x[j + 1]) & 0x00FF00FF00FF00FFull;
        x[j + 1] ^= t;
        x[j] ^= t << 8;
    }
    for (int j = 0; j < 6; j += (j & 1) ? 3 : 1) {  // 0, 1, 4, 5
        const uint64_t t = ((x[j] >> 16) ^ x[j + 2]) & 0x0000FFFF0000FFFFull;
        x[j + 2] ^= t;
        x[j] ^= t << 16;
    }
    for (int j = 0; j < 4; ++j) {
        const uint64_t t = ((x[j] >> 32) ^ x[j + 4]) & 0x00000000FFFFFFFFull;
        x[j + 4] ^= t;
        x[j] ^= t << 32;
    }
}

void unshuffle8(const uint8_t* in, int64_t n, uint8_t* out) {
    const int64_t blocks = n / 8 * 8;
    for (int64_t i = 0; i < blocks; i += 8) {
        uint64_t x[8];
        for (int j = 0; j < 8; ++j) std::memcpy(&x[j], in + j * n + i, 8);
        transpose8x8(x);
        std::memcpy(out + i * 8, x, 64);
    }
    unshuffle_fixed<uint64_t>(in + blocks, n - blocks, out + blocks * 8, n);
}

void shuffle8(const uint8_t* in, int64_t n, uint8_t* out) {
    const int64_t blocks = n / 8 * 8;
    for (int64_t i = 0; i < blocks; i += 8) {
        uint64_t x[8];
        std::memcpy(x, in + i * 8, 64);
        transpose8x8(x);
        for (int j = 0; j < 8; ++j) std::memcpy(out + j * n + i, &x[j], 8);
    }
    shuffle_fixed<uint64_t>(in + blocks * 8, n - blocks, out + blocks, n);
}

void unshuffle_any(const uint8_t* in, int64_t n, int64_t size, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i)
        for (int64_t j = 0; j < size; ++j) out[i * size + j] = in[j * n + i];
}

void shuffle_any(const uint8_t* in, int64_t n, int64_t size, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i)
        for (int64_t j = 0; j < size; ++j) out[j * n + i] = in[i * size + j];
}

constexpr bool kLittle = __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__;

}  // namespace

extern "C" {

// Undo the shuffle of the `n_bytes` bytes of `in` (elements of `size`
// bytes) into `out`, which holds `n_bytes` bytes and does not overlap `in`.
void hdf5_unshuffle(const uint8_t* in, int64_t n_bytes, int64_t size, uint8_t* out) {
    const int64_t n = size > 0 ? n_bytes / size : 0;
    if (size <= 1 || n == 0) {
        std::memcpy(out, in, n_bytes);
        return;
    }
    switch (kLittle ? size : 0) {
        case 2: unshuffle_fixed<uint16_t>(in, n, out, n); break;
        case 4: unshuffle_fixed<uint32_t>(in, n, out, n); break;
        case 8: unshuffle8(in, n, out); break;
        default: unshuffle_any(in, n, size, out);
    }
    std::memcpy(out + n * size, in + n * size, n_bytes - n * size);
}

// The shuffle itself, the inverse of hdf5_unshuffle (for the writer).
void hdf5_shuffle(const uint8_t* in, int64_t n_bytes, int64_t size, uint8_t* out) {
    const int64_t n = size > 0 ? n_bytes / size : 0;
    if (size <= 1 || n == 0) {
        std::memcpy(out, in, n_bytes);
        return;
    }
    switch (kLittle ? size : 0) {
        case 2: shuffle_fixed<uint16_t>(in, n, out, n); break;
        case 4: shuffle_fixed<uint32_t>(in, n, out, n); break;
        case 8: shuffle8(in, n, out); break;
        default: shuffle_any(in, n, size, out);
    }
    std::memcpy(out + n * size, in + n * size, n_bytes - n * size);
}

}  // extern "C"
