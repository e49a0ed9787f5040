// HDF5's szip filter (filter 4) for the HDF5 reader and writer
// (chromosight_torch/io/hdf5.py): the CCSDS 121.0-B adaptive entropy coder
// as libaec's szlib layer drives it, which is what h5py's HDF5 runs.
//
// A chunk is stored as its uncompressed size (4 bytes, little-endian) and
// then one bit stream.  The szlib layer codes samples of `bits per pixel`
// bits (8 or 16; samples of 16 bits in the byte order the options name),
// except that 32- and 64-bit pixels are split first: their bytes are
// interleaved by words of 4 or 8 bytes (HDF5's shuffle by that size) and
// coded as 8-bit samples.  The samples are cut into scanlines of `pixels
// per scanline` samples, each padded to whole blocks (the last sample
// repeated under the NN option, zeros otherwise) and coded as one reference
// sample interval (RSI): blocks of `pixels per block` samples, each the ID
// of its option and its codes.  With NN the samples go through a unit-delay
// predictor and CCSDS's mapping, and the first sample of an RSI is stored
// as it is (the reference).  The options: zero blocks (runs of all-zero
// blocks up to the end of a 64-block segment, 'remainder of segment'), the
// second extension (pairs coded together), k-split (k = 0 is the
// fundamental sequence) and no compression.  The szlib layer ignores the
// other option bits (K13, CHIP, RAW).
//
// The decoders stop as soon as the output is full and read a slice's chunks
// straight into the output on a few threads of their own (unshuffled when a
// shuffle precedes szip in the pipeline), as inflate.cpp does.  The encoder
// pads every scanline and codes every block (zero blocks, second
// extension, the best k or no compression), so libaec decodes what it
// writes.  Built with g++ at first use together with shuffle.cpp.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" void hdf5_unshuffle(const uint8_t* in, int64_t n_bytes, int64_t size, uint8_t* out);
extern "C" void hdf5_shuffle(const uint8_t* in, int64_t n_bytes, int64_t size, uint8_t* out);

namespace {

// error codes, shared with native/__init__.py's Python decoder
constexpr int64_t AEC_SHORT = -1;   // the stream ends before the output is full
constexpr int64_t AEC_CODE = -2;    // a code no encoder writes (a sample out of range,
                                    // a second-extension pair past the table, too
                                    // many zero blocks)
constexpr int64_t AEC_PARAMS = -4;  // options outside what HDF5's szip takes
constexpr int64_t AEC_SIZE = -5;    // an output that is not whole samples / words

constexpr int SZ_MSB = 16, SZ_NN = 32;
constexpr int SEGMENT = 64;  // blocks of a segment (zero runs end at its end)
constexpr int ROS = 5;       // zero-block count 5: the remainder of the segment
constexpr uint64_t SE_MAX = 90;  // second extension: codes of pairs summing to 12 at most

struct Layout {
    int n;         // bits per sample (8 or 16)
    int bytes;     // bytes per sample
    int block;     // samples per block
    int rsi;       // blocks per RSI (a scanline padded to whole blocks)
    int64_t pps;   // samples per scanline
    bool pp, msb;
    int word;      // > 1: pixels of this many bytes interleaved into 8-bit samples
    int id_len;
    uint32_t xmax;
};

bool layout(int mask, int ppb, int bpp, int pps, Layout* L) {
    if ((bpp != 8 && bpp != 16 && bpp != 32 && bpp != 64) || ppb < 2 || ppb > 32 || ppb % 2
        || pps < 1)
        return false;
    L->word = bpp > 16 ? bpp / 8 : 1;
    L->n = bpp > 16 ? 8 : bpp;
    L->bytes = L->n / 8;
    L->block = ppb;
    L->pps = pps;
    L->rsi = (pps + ppb - 1) / ppb;
    L->pp = mask & SZ_NN;
    L->msb = mask & SZ_MSB;
    L->id_len = L->n > 8 ? 4 : 3;
    L->xmax = (1u << L->n) - 1;
    return true;
}

// -- decoding ------------------------------------------------------------- //

// Bits most significant first: `acc` holds `have` valid bits at its top,
// the bits below them zero.
struct Reader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t acc = 0;
    int have = 0;

    void refill() {
        if (end - p >= 8) {
            uint64_t w;
            std::memcpy(&w, p, 8);
            w = __builtin_bswap64(w);
            acc |= w >> have;
            const int take = (64 - have) >> 3;
            p += take;
            have += take * 8;
            if (have < 64) acc &= ~(~0ULL >> have);
        } else {
            while (have <= 56 && p < end) {
                acc |= uint64_t(*p++) << (56 - have);
                have += 8;
            }
        }
    }

    // k bits (1 to 32); false when the stream ends first
    bool get(int k, uint32_t* v) {
        if (have < k) {
            refill();
            if (have < k) return false;
        }
        *v = uint32_t(acc >> (64 - k));
        acc <<= k;
        have -= k;
        return true;
    }

    // a fundamental-sequence code: the zeros before the next one bit
    bool fs(uint64_t* v) {
        uint64_t zeros = 0;
        for (;;) {
            if (acc == 0) {
                zeros += have;
                have = 0;
                refill();
                if (have == 0) return false;
                continue;
            }
            const int c = __builtin_clzll(acc);
            zeros += c;
            acc <<= c;
            acc <<= 1;
            have -= c + 1;
            *v = zeros;
            return true;
        }
    }
};

// Second extension: the pair (beta - d1, d1) of code m, with
// beta (beta + 1) / 2 <= m the largest such triangle number.
struct SETable {
    uint8_t beta[SE_MAX + 1], ms[SE_MAX + 1];
    SETable() {
        int m = 0;
        for (int b = 0; m <= int(SE_MAX); ++b)
            for (int j = 0; j <= b && m <= int(SE_MAX); ++j, ++m) {
                beta[m] = uint8_t(b);
                ms[m] = uint8_t(b * (b + 1) / 2);
            }
    }
};
const SETable SE;

template <int WIDTH, bool MSB>
inline void put_sample(uint8_t* out, uint32_t x) {
    if (WIDTH == 1) {
        *out = uint8_t(x);
    } else if (MSB) {
        out[0] = uint8_t(x >> 8);
        out[1] = uint8_t(x);
    } else {
        out[0] = uint8_t(x);
        out[1] = uint8_t(x >> 8);
    }
}

template <int WIDTH, bool PP, bool MSB>
void postprocess_as(const uint32_t* v, int64_t count, uint8_t* out, uint32_t xmax) {
    if (!PP) {
        for (int64_t i = 0; i < count; ++i) put_sample<WIDTH, MSB>(out + i * WIDTH, v[i]);
        return;
    }
    uint32_t x = v[0];
    put_sample<WIDTH, MSB>(out, x);
    for (int64_t i = 1; i < count; ++i) {
        const uint32_t d = v[i];
        if (d != 0) {  // a zero repeats the sample (the runs of zero blocks)
            const uint32_t theta = std::min(x, xmax - x);
            const uint32_t inside = (d & 1) ? x - ((d + 1) >> 1) : x + (d >> 1);
            const uint32_t outside = theta == x ? d : xmax - d;
            x = d <= 2 * theta ? inside : outside;
        }
        put_sample<WIDTH, MSB>(out + i * WIDTH, x);
    }
}

// The samples of `count` RSI values (the reference, then mapped
// differences under NN) into `out`.
void postprocess(const uint32_t* v, int64_t count, uint8_t* out, const Layout& L) {
    if (L.bytes == 1)
        (L.pp ? postprocess_as<1, true, false> : postprocess_as<1, false, false>)(v, count, out,
                                                                                 L.xmax);
    else if (L.msb)
        (L.pp ? postprocess_as<2, true, true> : postprocess_as<2, false, true>)(v, count, out,
                                                                               L.xmax);
    else
        (L.pp ? postprocess_as<2, true, false> : postprocess_as<2, false, false>)(v, count, out,
                                                                                 L.xmax);
}

// The sample stream of one szip body into `out` (`out_bytes` bytes):
// 0, or an error code.
int64_t decode_samples(const uint8_t* in, int64_t n_in, uint8_t* out, int64_t out_bytes,
                       const Layout& L, std::vector<uint32_t>& buf) {
    if (out_bytes % L.bytes) return AEC_SIZE;
    const int64_t need = out_bytes / L.bytes;
    const int J = L.block;
    const int64_t rsi_size = int64_t(L.rsi) * J;
    buf.resize(rsi_size);
    Reader r{in, in + n_in};
    const uint32_t uncompressed = (1u << L.id_len) - 1;
    for (int64_t done = 0; done < need;) {
        const int64_t line = std::min<int64_t>(L.pps, need - done);
        int64_t used = 0;
        while (used < line) {
            const int ref = L.pp && used == 0;
            uint32_t id, v;
            if (!r.get(L.id_len, &id)) return AEC_SHORT;
            if (id == 0) {
                uint32_t second;
                if (!r.get(1, &second)) return AEC_SHORT;
                if (ref) {
                    if (!r.get(L.n, &v)) return AEC_SHORT;
                    buf[used++] = v;
                }
                if (!second) {
                    uint64_t fs;
                    if (!r.fs(&fs)) return AEC_SHORT;
                    uint64_t blocks = fs + 1;
                    const int64_t b = used / J;
                    if (blocks == ROS)
                        blocks = std::min<int64_t>(L.rsi - b, SEGMENT - b % SEGMENT);
                    else if (blocks > ROS)
                        blocks -= 1;
                    if (blocks > uint64_t(rsi_size)) return AEC_CODE;
                    const int64_t zeros = int64_t(blocks) * J - ref;
                    if (zeros > rsi_size - used) return AEC_CODE;
                    std::fill(buf.begin() + used, buf.begin() + used + zeros, 0u);
                    used += zeros;
                } else {
                    for (int i = ref; i < J;) {
                        uint64_t m;
                        if (!r.fs(&m)) return AEC_SHORT;
                        if (m > SE_MAX) return AEC_CODE;
                        const uint32_t d1 = uint32_t(m) - SE.ms[m];
                        if ((i & 1) == 0) {
                            buf[used++] = SE.beta[m] - d1;
                            ++i;
                        }
                        buf[used++] = d1;
                        ++i;
                    }
                }
            } else if (id == uncompressed) {
                for (int i = 0; i < J; ++i) {
                    if (!r.get(L.n, &v)) return AEC_SHORT;
                    buf[used++] = v;
                }
            } else {
                const int k = int(id) - 1;
                if (ref) {
                    if (!r.get(L.n, &v)) return AEC_SHORT;
                    buf[used++] = v;
                }
                const int count = J - ref;
                const uint64_t top = L.xmax >> k;
                for (int i = 0; i < count; ++i) {
                    uint64_t fs;
                    if (!r.fs(&fs)) return AEC_SHORT;
                    if (fs > top) return AEC_CODE;
                    buf[used + i] = uint32_t(fs) << k;
                }
                if (k)
                    for (int i = 0; i < count; ++i) {
                        if (!r.get(k, &v)) return AEC_SHORT;
                        buf[used + i] |= v;
                    }
                used += count;
            }
        }
        postprocess(buf.data(), line, out + done * L.bytes, L);
        done += line;
    }
    return 0;
}

// One szip body (the stream after the size) into `out_bytes` bytes of
// pixels: decoded, then de-interleaved for 32- and 64-bit pixels.
int64_t decode_body(const uint8_t* in, int64_t n_in, uint8_t* out, int64_t out_bytes,
                    const Layout& L, std::vector<uint32_t>& buf, std::vector<uint8_t>& scratch) {
    if (L.word == 1) return decode_samples(in, n_in, out, out_bytes, L, buf);
    if (out_bytes % L.word) return AEC_SIZE;
    scratch.resize(out_bytes);
    const int64_t got = decode_samples(in, n_in, scratch.data(), out_bytes, L, buf);
    if (got == 0) hdf5_unshuffle(scratch.data(), out_bytes, L.word, out);
    return got;
}

// -- encoding ------------------------------------------------------------- //

struct Writer {
    uint8_t* p;
    uint8_t* end;
    uint64_t acc = 0;
    int have = 0;
    bool full = false;

    void put(uint32_t v, int k) {  // k from 0 to 32
        acc = (acc << k) | v;
        have += k;
        while (have >= 8) {
            have -= 8;
            if (p < end)
                *p++ = uint8_t(acc >> have);
            else
                full = true;
        }
    }
    void fs(uint64_t v) {
        for (; v >= 32; v -= 32) put(0, 32);
        put(1, int(v) + 1);
    }
    void flush() {
        if (have) put(0, 8 - have);
    }
};

// Code one RSI of `L.rsi` blocks (the reference then mapped differences
// under NN, the samples otherwise).
void encode_rsi(const uint32_t* v, const Layout& L, Writer& w) {
    const int J = L.block;
    const int kmax = (1 << L.id_len) - 3;
    const uint32_t uncompressed = (1u << L.id_len) - 1;
    int run = 0, run_start = 0;
    auto zero_run = [&](bool ends_segment) {
        w.put(0, L.id_len);
        w.put(0, 1);
        if (L.pp && run_start == 0) w.put(v[0], L.n);
        if (ends_segment && run > 4)
            w.fs(ROS - 1);
        else
            w.fs(run >= ROS ? run : run - 1);
        run = 0;
    };
    for (int b = 0; b < L.rsi; ++b) {
        const uint32_t* d = v + int64_t(b) * J;
        const int ref = L.pp && b == 0;
        bool zero = true;
        uint64_t sum = 0;
        for (int i = ref; i < J; ++i) {
            zero &= d[i] == 0;
            sum += d[i];
        }
        const bool segment_end = (b + 1) % SEGMENT == 0 || b + 1 == L.rsi;
        if (zero) {
            if (run == 0) run_start = b;
            ++run;
            if (segment_end) zero_run(true);
            continue;
        }
        if (run) zero_run(false);
        const int count = J - ref;
        // bits after the ID: no compression, each k-split, second extension
        uint64_t best = uint64_t(J) * L.n;
        int choice = -1;  // -1: no compression, -2: second extension, else k
        for (int k = 0; k <= kmax; ++k) {
            uint64_t bits = uint64_t(ref) * L.n + uint64_t(count) * (k + 1);
            for (int i = ref; i < J && bits < best; ++i) bits += d[i] >> k;
            if (bits < best) {
                best = bits;
                choice = k;
            }
            if ((sum >> k) < uint64_t(count)) break;  // larger k only adds bits
        }
        uint64_t se = 1 + uint64_t(ref) * L.n;
        for (int i = 0; i < J && se < best; i += 2) {
            const uint64_t a = i == 0 && ref ? 0 : d[i], c = d[i + 1];
            if (a + c > 12) {
                se = best;
                break;
            }
            se += (a + c) * (a + c + 1) / 2 + c + 1;
        }
        if (se < best) choice = -2;
        if (choice == -1) {
            w.put(uncompressed, L.id_len);
            for (int i = 0; i < J; ++i) w.put(d[i], L.n);
        } else if (choice == -2) {
            w.put(0, L.id_len);
            w.put(1, 1);
            if (ref) w.put(d[0], L.n);
            for (int i = 0; i < J; i += 2) {
                const uint64_t a = i == 0 && ref ? 0 : d[i], c = d[i + 1];
                w.fs((a + c) * (a + c + 1) / 2 + c);
            }
        } else {
            w.put(uint32_t(choice) + 1, L.id_len);
            if (ref) w.put(d[0], L.n);
            for (int i = ref; i < J; ++i) w.fs(d[i] >> choice);
            if (choice)
                for (int i = ref; i < J; ++i) w.put(d[i] & ((1u << choice) - 1), choice);
        }
        if (w.full) return;
    }
}

uint32_t get_sample(const uint8_t* in, const Layout& L) {
    if (L.bytes == 1) return in[0];
    return L.msb ? (uint32_t(in[0]) << 8) | in[1] : (uint32_t(in[1]) << 8) | in[0];
}

// The szip stream of `n_bytes` bytes of samples into [out, end): its
// length, or -1 when it does not fit.
int64_t encode_samples(const uint8_t* in, int64_t n_bytes, uint8_t* out, uint8_t* end,
                       const Layout& L, std::vector<uint32_t>& v) {
    const int64_t ns = n_bytes / L.bytes;
    const int64_t rsi_size = int64_t(L.rsi) * L.block;
    v.resize(rsi_size);
    Writer w{out, end};
    for (int64_t start = 0; start < ns; start += L.pps) {
        const int64_t m = std::min<int64_t>(L.pps, ns - start);
        uint32_t last = 0;
        for (int64_t i = 0; i < rsi_size; ++i) {
            const uint32_t x = i < m ? get_sample(in + (start + i) * L.bytes, L)
                                     : (L.pp ? last : 0u);
            if (!L.pp) {
                v[i] = x;
            } else if (i == 0) {
                v[i] = x;
            } else {
                // CCSDS's mapping of the difference to the previous sample
                const int64_t delta = int64_t(x) - int64_t(last);
                const int64_t theta = std::min<int64_t>(last, L.xmax - last);
                if (delta >= 0 && delta <= theta)
                    v[i] = uint32_t(2 * delta);
                else if (delta < 0 && -delta <= theta)
                    v[i] = uint32_t(-2 * delta - 1);
                else
                    v[i] = uint32_t(theta + (delta < 0 ? -delta : delta));
            }
            last = x;
        }
        encode_rsi(v.data(), L, w);
        if (w.full) return -1;
    }
    w.flush();
    return w.full ? -1 : w.p - out;
}

template <typename Work>
void on_threads(int64_t n, int64_t threads, Work work) {
    const int64_t t = std::max<int64_t>(1, std::min(threads, n));
    std::vector<std::thread> pool;
    for (int64_t k = 1; k < t; ++k) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// One szip body (the stream after the 4-byte size) decoded into
// `out_bytes` bytes of pixels: 0, or a negative error code.
int64_t hdf5_aec_decode(const uint8_t* in, int64_t n_in, uint8_t* out, int64_t out_bytes,
                        int mask, int ppb, int bpp, int pps) {
    Layout L;
    if (!layout(mask, ppb, bpp, pps, &L)) return AEC_PARAMS;
    std::vector<uint32_t> buf;
    std::vector<uint8_t> scratch;
    return decode_body(in, n_in, out, out_bytes, L, buf, scratch);
}

// Chunk i is in_len[i] bytes at in + in_off[i], an szip chunk that must
// hold exactly chunk_bytes bytes; they go to out + out_off[i], unshuffled
// by elements of `element` bytes when element > 1 (a shuffle before szip).
// Runs on `threads` threads.  Returns -1 when every chunk decoded, else
// the index of one that did not.
int64_t hdf5_szip_chunks(const uint8_t* in, const int64_t* in_off, const int64_t* in_len,
                         int64_t n, uint8_t* out, const int64_t* out_off, int64_t chunk_bytes,
                         int mask, int ppb, int bpp, int pps, int64_t element,
                         int64_t threads) {
    Layout L;
    if (!layout(mask, ppb, bpp, pps, &L)) return n ? 0 : -1;
    std::atomic<int64_t> next{0};
    std::atomic<int64_t> failed{-1};
    on_threads(n, threads, [&]() {
        std::vector<uint32_t> buf;
        std::vector<uint8_t> scratch, unshuffled(element > 1 ? chunk_bytes : 0);
        for (int64_t i = next++; i < n && failed.load() < 0; i = next++) {
            const uint8_t* src = in + in_off[i];
            int64_t got = AEC_SIZE;
            if (in_len[i] >= 4) {
                const uint32_t size = uint32_t(src[0]) | uint32_t(src[1]) << 8
                                      | uint32_t(src[2]) << 16 | uint32_t(src[3]) << 24;
                uint8_t* dst = element > 1 ? unshuffled.data() : out + out_off[i];
                if (size == uint64_t(chunk_bytes))
                    got = decode_body(src + 4, in_len[i] - 4, dst, chunk_bytes, L, buf, scratch);
            }
            if (got != 0) {
                int64_t none = -1;
                failed.compare_exchange_strong(none, i);
                return;
            }
            if (element > 1) hdf5_unshuffle(unshuffled.data(), chunk_bytes, element,
                                            out + out_off[i]);
        }
    });
    return failed.load();
}

// Chunks k < n of chunk_bytes bytes each at in + k * chunk_bytes, each
// shuffled by elements of `element` bytes first when element > 1, then
// coded by szip with these options into out + k * (chunk_bytes + 4): the
// 4-byte size and the stream, out_len[k] bytes.  A chunk whose stream
// would pass chunk_bytes bytes (HDF5 then stores it without szip, its
// filter-mask bit set) gets out_len[k] = 0 and its shuffled bytes in the
// slot.  Runs on `threads` threads; the output does not depend on them.
// Returns 0, or AEC_PARAMS.
int64_t hdf5_szip_encode_chunks(const uint8_t* in, int64_t n, int64_t chunk_bytes,
                                int64_t element, int mask, int ppb, int bpp, int pps,
                                uint8_t* out, int64_t* out_len, int64_t threads) {
    Layout L;
    if (!layout(mask, ppb, bpp, pps, &L) || chunk_bytes % (L.bytes * L.word)) return AEC_PARAMS;
    const int64_t slot = chunk_bytes + 4;
    std::atomic<int64_t> next{0};
    on_threads(n, threads, [&]() {
        std::vector<uint32_t> v;
        std::vector<uint8_t> shuffled(element > 1 ? chunk_bytes : 0);
        std::vector<uint8_t> interleaved(L.word > 1 ? chunk_bytes : 0);
        for (int64_t k = next++; k < n; k = next++) {
            const uint8_t* raw = in + k * chunk_bytes;
            uint8_t* dst = out + k * slot;
            if (element > 1) {
                hdf5_shuffle(raw, chunk_bytes, element, shuffled.data());
                raw = shuffled.data();
            }
            const uint8_t* samples = raw;
            if (L.word > 1) {
                hdf5_shuffle(raw, chunk_bytes, L.word, interleaved.data());
                samples = interleaved.data();
            }
            const int64_t got = encode_samples(samples, chunk_bytes, dst + 4, dst + slot, L, v);
            if (got < 0 || got > chunk_bytes) {
                std::memcpy(dst, raw, chunk_bytes);
                out_len[k] = 0;
                continue;
            }
            for (int j = 0; j < 4; ++j) dst[j] = uint8_t(uint64_t(chunk_bytes) >> (8 * j));
            out_len[k] = got + 4;
        }
    });
    return 0;
}

}  // extern "C"
