// JSON windows for the window writer (chromosight_torch/io/writers.py): a
// C-contiguous stack of float64 windows written as
// json.dump({i: window.tolist()}, handle, indent=4) writes it, byte for
// byte.  Each value takes Python's float repr (the shortest digits that
// read back to the same double, from std::to_chars) and json's names for
// NaN and the infinities; the frame is indent=4's.  The windows are
// formatted in blocks, each block's windows split over a few threads of
// its own into buffers reused across blocks, and the buffers written in
// order, so that the host memory stays bounded whatever the number of
// windows.  Built with g++ at first use.

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// most bytes one value takes ("-2.2250738585072014e-308" is 24)
constexpr int64_t VALUE_MAX = 32;
// most bytes of a window key: ",\n" or "\n", four spaces, the quoted index,
// ": "
constexpr int64_t KEY_MAX = 40;

char* put(char* out, const char* text, size_t n) {
    std::memcpy(out, text, n);
    return out + n;
}

char* spaces(char* out, int n) {
    std::memset(out, ' ', n);
    return out + n;
}

// float.__repr__ of v as json writes it: NaN, Infinity and -Infinity by
// name; else the shortest round-trip digits, in exponent form when the
// decimal point falls more than 16 digits right of the first digit or 4
// or more left of it (1e-05, 1.5e+16), else fixed with ".0" after a whole
// number.
char* put_double(char* out, double v) {
    if (std::isnan(v)) return put(out, "NaN", 3);
    if (std::isinf(v)) return v > 0 ? put(out, "Infinity", 8) : put(out, "-Infinity", 9);
    if (v == 0.0) return std::signbit(v) ? put(out, "-0.0", 4) : put(out, "0.0", 3);
    char sci[VALUE_MAX];
    const char* end = std::to_chars(sci, sci + sizeof sci, v, std::chars_format::scientific).ptr;
    const char* p = sci;
    if (*p == '-') *out++ = *p++;
    char digits[20];
    int nd = 0;
    const char* e = p;
    for (; *e != 'e'; ++e)
        if (*e != '.') digits[nd++] = *e;
    int exp = 0;
    for (const char* x = e + 2; x < end; ++x) exp = 10 * exp + (*x - '0');
    const int decpt = (e[1] == '-' ? -exp : exp) + 1;
    if (decpt <= -4 || decpt > 16) return put(out, p, end - p);  // to_chars' is repr's
    if (decpt <= 0) {
        out = put(out, "0.", 2);
        std::memset(out, '0', -decpt);
        return put(out - decpt, digits, nd);
    }
    if (nd <= decpt) {
        out = put(out, digits, nd);
        std::memset(out, '0', decpt - nd);
        return put(out + decpt - nd, ".0", 2);
    }
    out = put(out, digits, decpt);
    *out++ = '.';
    return put(out, digits + decpt, nd - decpt);
}

// an indent=4 list at depth `depth` (its items at depth + 1): "[]" when
// empty, else "[", each item on its own line, ",\n" between them, and the
// "]" on a line of its own
template <class Item>
char* put_list(char* out, int64_t n, int depth, Item item) {
    if (n == 0) return put(out, "[]", 2);
    *out++ = '[';
    for (int64_t i = 0; i < n; ++i) {
        out = put(out, i ? ",\n" : "\n", i ? 2 : 1);
        out = item(spaces(out, 4 * (depth + 1)), i);
    }
    *out++ = '\n';
    return put(spaces(out, 4 * depth), "]", 1);
}

// window w of the stack, with its key and the separator before it
char* put_window(char* out, const double* win, int64_t w, int64_t rows, int64_t cols) {
    out = put(out, w ? ",\n    \"" : "\n    \"", w ? 7 : 6);
    out = std::to_chars(out, out + 24, w).ptr;
    out = put(out, "\": ", 3);
    return put_list(out, rows, 1, [&](char* o, int64_t r) {
        const double* row = win + r * cols;
        return put_list(o, cols, 2, [&](char* q, int64_t c) { return put_double(q, row[c]); });
    });
}

int write_all(int fd, const char* p, size_t n) {
    while (n) {
        const ssize_t got = ::write(fd, p, n);
        if (got < 0) {
            if (errno == EINTR) continue;
            return errno;
        }
        p += got;
        n -= static_cast<size_t>(got);
    }
    return 0;
}

}  // namespace

extern "C" {

// Write the n windows of rows x cols float64 values at `data` (C order) to
// a new file at `path` (created or truncated, mode 0666 less the umask),
// `block` windows at a time on `threads` threads.  Returns the bytes
// written, or minus the errno of a failed open or write.
int64_t json_windows_write(const char* path, const double* data, int64_t n, int64_t rows,
                           int64_t cols, int64_t block, int64_t threads) {
    const int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC, 0666);
    if (fd < 0) return -errno;
    const int64_t per_window = KEY_MAX + rows * (cols * (VALUE_MAX + 14) + 24) + 16;
    const int64_t t = std::max<int64_t>(1, std::min(threads, block));
    std::vector<std::vector<char>> bufs(t);
    std::vector<int64_t> used(t);
    int64_t total = 0;
    int err = write_all(fd, n ? "{" : "{}", n ? 1 : 2);
    for (int64_t start = 0; start < n && !err; start += block) {
        const int64_t stop = std::min(n, start + block);
        const int64_t share = (stop - start + t - 1) / t;
        auto work = [&](int64_t k) {
            const int64_t lo = std::min(stop, start + k * share);
            const int64_t hi = std::min(stop, lo + share);
            std::vector<char>& buf = bufs[k];
            if (static_cast<int64_t>(buf.size()) < (hi - lo) * per_window)
                buf.resize((hi - lo) * per_window);
            char* out = buf.data();
            for (int64_t w = lo; w < hi; ++w)
                out = put_window(out, data + w * rows * cols, w, rows, cols);
            used[k] = out - buf.data();
        };
        std::vector<std::thread> pool;
        for (int64_t k = 1; k < t; ++k) pool.emplace_back(work, k);
        work(0);
        for (auto& th : pool) th.join();
        for (int64_t k = 0; k < t && !err; ++k) {
            err = write_all(fd, bufs[k].data(), used[k]);
            total += used[k];
        }
    }
    if (n && !err) err = write_all(fd, "\n}", 2);
    if (::close(fd) && !err) err = errno;
    return err ? -err : total + (n ? 3 : 2);
}

}  // extern "C"
