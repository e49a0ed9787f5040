// LZF decompression for the HDF5 reader (chromosight_torch/io/hdf5.py):
// the chunks of h5py's LZF filter (filter 32000), which stores each chunk
// as one LZF block (liblzf's format: a control byte either starts a run
// of 1-32 literal bytes or a back reference of 3-264 bytes at a distance
// of 1-8192).  Built with g++ at first use, as kernels.cpp is.

#include <cstdint>

extern "C" {

// Decompress `n_in` bytes of `in` into `out` (room for `n_out` bytes).
// Returns the number of bytes written; -1 when the output does not fit,
// -2 when the input is not a valid LZF block.
int64_t lzf_decompress(const uint8_t* in, int64_t n_in, uint8_t* out, int64_t n_out) {
    const uint8_t* ip = in;
    const uint8_t* const in_end = in + n_in;
    uint8_t* op = out;
    uint8_t* const out_end = out + n_out;
    while (ip < in_end) {
        uint32_t ctrl = *ip++;
        if (ctrl < (1u << 5)) {
            ctrl++;
            if (op + ctrl > out_end) return -1;
            if (ip + ctrl > in_end) return -2;
            for (uint32_t i = 0; i < ctrl; ++i) *op++ = *ip++;
        } else {
            uint32_t len = ctrl >> 5;
            if (len == 7) {
                if (ip >= in_end) return -2;
                len += *ip++;
            }
            if (ip >= in_end) return -2;
            const int64_t back = (int64_t(ctrl & 0x1f) << 8) + *ip++ + 1;
            len += 2;
            if (op + len > out_end) return -1;
            if (back > op - out) return -2;
            const uint8_t* ref = op - back;
            for (uint32_t i = 0; i < len; ++i) *op++ = *ref++;
        }
    }
    return op - out;
}

}  // extern "C"
