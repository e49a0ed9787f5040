// HDF5's n-bit (filter 5) and scale-offset (filter 6) decoders for the
// HDF5 reader (chromosight_torch/io/hdf5.py), on integer and float
// elements of 1, 2, 4 or 8 bytes.  Both filters store each element as a
// run of bits, the runs packed one after the other most significant bit
// first (H5Znbit.c, H5Zscaleoffset.c).  Built with g++ at first use, as
// lzf.cpp is; native/__init__.py holds the numpy versions.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// The next `bits` bits of the stream at bit `pos` (bits <= 64); false when
// the stream ends first.
inline bool take(const uint8_t* in, int64_t n_in, int64_t& pos, int bits, uint64_t& value) {
    if (pos + bits > n_in * 8) return false;
    value = 0;
    for (int b = 0; b < bits;) {
        const int64_t byte = pos >> 3;
        const int used = int(pos & 7);
        const int n = (8 - used) < (bits - b) ? (8 - used) : (bits - b);
        const uint64_t chunk = (in[byte] >> (8 - used - n)) & ((1u << n) - 1);
        value = (value << n) | chunk;
        b += n;
        pos += n;
    }
    return true;
}

// Store the low `size` bytes of `value` in byte order `order` (0: little
// endian, 1: big endian).
inline void put(uint8_t* out, int size, int order, uint64_t value) {
    for (int k = 0; k < size; ++k) {
        const uint8_t byte = uint8_t(value >> (8 * k));
        out[order ? size - 1 - k : k] = byte;
    }
}

inline uint64_t get(const uint8_t* in, int size) {
    uint64_t value = 0;
    std::memcpy(&value, in, size);  // little-endian host
    return value;
}

}  // namespace

extern "C" {

// n-bit: `n` elements of `size` bytes, each `precision` bits stored, placed
// at bit `offset` of the element (its other bits 0), written in byte
// order `order`.  0 on success, -1 when the input ends early.
int64_t hdf5_nbit_decode(const uint8_t* in, int64_t n_in, int64_t n, int size, int order,
                         int precision, int offset, uint8_t* out) {
    int64_t pos = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t v;
        if (!take(in, n_in, pos, precision, v)) return -1;
        put(out + i * size, size, order, offset < 64 ? v << offset : 0);
    }
    return 0;
}

// scale-offset: the 21-byte header (minbits, then the minimum in 8 bytes
// after a byte giving its width), then `n` elements of minbits bits each;
// integers are the stored value plus the minimum, floats (D-scaling by
// `scale` decimal digits) the stored value read as a signed integer over
// 10^scale plus the minimum, in the float's own arithmetic; the stored
// all-ones value is the fill value when `filavail`.  Elements of `size`
// bytes, written in byte order `order`.  0 on success, -1 when the input
// ends early.
int64_t hdf5_scaleoffset_decode(const uint8_t* in, int64_t n_in, int64_t n, int is_float,
                                int size, int order, int scale, int filavail,
                                const uint8_t* fill, uint8_t* out) {
    if (n_in < 21) return -1;
    const int minbits = int(get(in, 4));
    const int min_width = in[4] < 8 ? in[4] : 8;
    const uint64_t minval = get(in + 5, min_width);
    const uint8_t* data = in + 21;
    const int64_t n_data = n_in - 21;
    if (minbits == size * 8) {
        if (n_data < n * size) return -1;
        for (int64_t i = 0; i < n; ++i) put(out + i * size, size, order, get(data + i * size, size));
        return 0;
    }
    // HDF5 compares with (1 << minbits) - 1 even when minbits is 0
    const uint64_t all_ones = minbits == 64 ? ~0ull : (1ull << minbits) - 1;
    const uint64_t fill_value = filavail ? get(fill, size) : 0;
    int64_t pos = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t v = 0;
        if (minbits && !take(data, n_data, pos, minbits, v)) return -1;
        uint64_t value;
        if (filavail && v == all_ones) {
            value = fill_value;
        } else if (!is_float) {
            value = v + minval;
        } else if (size == 4) {
            float min, x;
            uint32_t bits = uint32_t(minval);
            std::memcpy(&min, &bits, 4);
            x = float(int32_t(uint32_t(v))) / powf(10.0f, float(scale)) + min;
            std::memcpy(&bits, &x, 4);
            value = bits;
        } else {
            double min, x;
            std::memcpy(&min, &minval, 8);
            x = double(int64_t(v)) / std::pow(10.0, double(scale)) + min;
            std::memcpy(&value, &x, 8);
        }
        put(out + i * size, size, order, value);
    }
    return 0;
}

}  // extern "C"
