// Host entries in C++ with a plain C ABI (ctypes): the ingest scanners and
// their thread pool, the serve tick's scratch fill and the admission
// plane's columnar SFQ scans.  The port's own copy of the JAX package's
// native runtime (native/anomod_native.cpp: contains_ci, parse_ts, the
// Runtime pool, anomod_rt_*, anomod_scan_csv_cols, anomod_scan_log,
// anomod_scan_log_mt, anomod_scan_api_jsonl, anomod_stage_lanes_mat,
// anomod_sfq_drain, anomod_sfq_victim), the staging entry adapted to the
// lane kernel's scratch layout.  The scanners give the JAX library's bytes
// on every input: the same line splits, substring tests, timestamp window,
// strtod parses and timegm normalization.
//
// Build (anomod_torch/io/native.py does it at first use):
//   g++ -O3 -shared -fPIC -pthread -std=c++17
// No -ffast-math: the fill writes dur^2 with one IEEE f32 multiply, the
// same rounding numpy's np.multiply gives, so the scratch is bit-exact.
//
// State and lifetimes: a pool (atn_rt_create) owns its worker threads from
// create to destroy; destroy drains the queue and joins them, so the caller
// must not destroy a pool another thread is still calling into.  Each pool
// worker owns one thread-local read buffer (atn_rt_summarize_logs), grown
// to the largest file it has read and freed when the worker exits.
// atn_scan_log_mt starts and joins its own threads within the call.  Every
// other entry is a pure function over caller-owned arrays.  ctypes releases
// the GIL for every call.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// Case-insensitive (ASCII) substring search.
inline bool contains_ci(const char* hay, size_t n, const char* needle) {
    const size_t m = std::strlen(needle);
    if (m > n) return false;
    const char c0l = (char)std::tolower(needle[0]);
    for (size_t i = 0; i + m <= n; ++i) {
        if ((char)std::tolower(hay[i]) != c0l) continue;
        size_t j = 1;
        for (; j < m; ++j)
            if ((char)std::tolower(hay[i + j]) != (char)std::tolower(needle[j]))
                break;
        if (j == m) return true;
    }
    return false;
}

// The first "YYYY-MM-DD[T ]HH:MM:SS" starting in the line's first 64 bytes,
// as epoch seconds through timegm (which normalizes out-of-range fields);
// 0 when there is none.
inline double parse_ts(const char* line, size_t n) {
    const size_t limit = n < 64 ? n : 64;
    for (size_t i = 0; i + 19 <= limit; ++i) {
        const char* p = line + i;
        if (std::isdigit(p[0]) && std::isdigit(p[1]) && std::isdigit(p[2]) &&
            std::isdigit(p[3]) && p[4] == '-' && std::isdigit(p[5]) &&
            std::isdigit(p[6]) && p[7] == '-' && std::isdigit(p[8]) &&
            std::isdigit(p[9]) && (p[10] == ' ' || p[10] == 'T') &&
            std::isdigit(p[11]) && std::isdigit(p[12]) && p[13] == ':' &&
            std::isdigit(p[14]) && std::isdigit(p[15]) && p[16] == ':' &&
            std::isdigit(p[17]) && std::isdigit(p[18])) {
            std::tm tm{};
            tm.tm_year = (p[0]-'0')*1000 + (p[1]-'0')*100 + (p[2]-'0')*10 + (p[3]-'0') - 1900;
            tm.tm_mon  = (p[5]-'0')*10 + (p[6]-'0') - 1;
            tm.tm_mday = (p[8]-'0')*10 + (p[9]-'0');
            tm.tm_hour = (p[11]-'0')*10 + (p[12]-'0');
            tm.tm_min  = (p[14]-'0')*10 + (p[15]-'0');
            tm.tm_sec  = (p[17]-'0')*10 + (p[18]-'0');
            return (double)timegm(&tm);
        }
    }
    return 0.0;
}

// Level code of one line: 0 info, 1 warn, 2 error, 3 other (the schemas'
// LOG_* codes; collect_log.sh:104-106's grep -c -i, "exception" an error).
inline int8_t line_level(const char* p, size_t n) {
    if (contains_ci(p, n, "error") || contains_ci(p, n, "exception"))
        return 2;
    if (contains_ci(p, n, "warn")) return 1;
    if (contains_ci(p, n, "info")) return 0;
    return 3;
}

// A fixed set of workers over one FIFO task queue, with a wait-all
// barrier; one pool serves many batch submissions.
class ThreadPool {
 public:
    explicit ThreadPool(int n_threads) {
        if (n_threads < 1) n_threads = 1;
        for (int i = 0; i < n_threads; ++i)
            workers_.emplace_back([this] { worker_loop(); });
    }

    ~ThreadPool() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& t : workers_) t.join();
    }

    void submit(std::function<void()> fn) {
        {
            std::unique_lock<std::mutex> lk(mu_);
            queue_.push(std::move(fn));
        }
        cv_.notify_one();
    }

    void wait_all() {
        std::unique_lock<std::mutex> lk(mu_);
        done_cv_.wait(lk, [this] { return queue_.empty() && active_ == 0; });
    }

    int n_threads() const { return (int)workers_.size(); }

 private:
    void worker_loop() {
        for (;;) {
            std::function<void()> task;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
                if (stop_ && queue_.empty()) return;
                task = std::move(queue_.front());
                queue_.pop();
                ++active_;
            }
            task();
            {
                std::unique_lock<std::mutex> lk(mu_);
                --active_;
                if (queue_.empty() && active_ == 0) done_cv_.notify_all();
            }
        }
    }

    std::vector<std::thread> workers_;
    std::queue<std::function<void()>> queue_;
    std::mutex mu_;
    std::condition_variable cv_;
    std::condition_variable done_cv_;
    bool stop_ = false;
    int active_ = 0;
};

// A worker's read buffer, reused across the files it reads.
thread_local std::vector<char> tl_read_buf;

// Reads a whole file into the thread's buffer; returns its size, or -1.
inline int64_t read_file(const char* path) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    const long sz = std::ftell(f);
    if (sz < 0) { std::fclose(f); return -1; }
    std::fseek(f, 0, SEEK_SET);
    if (tl_read_buf.size() < (size_t)sz) tl_read_buf.resize((size_t)sz);
    const size_t got = sz ? std::fread(tl_read_buf.data(), 1, (size_t)sz, f)
                          : 0;
    std::fclose(f);
    return (int64_t)got;
}

// The number after "key" in one JSONL line (any ':' and ' ' between), by
// strtod from there on; false when the key is absent or nothing parses.
inline bool find_num(const char* line, size_t n, const char* key,
                     double* out) {
    const size_t klen = std::strlen(key);
    for (size_t i = 0; i + klen + 1 < n; ++i) {
        if (line[i] == '"' && i + 1 + klen < n &&
            std::memcmp(line + i + 1, key, klen) == 0 &&
            line[i + 1 + klen] == '"') {
            const char* q = line + i + 2 + klen;
            while (q < line + n && (*q == ':' || *q == ' ')) ++q;
            char* endq = nullptr;
            const double v = std::strtod(q, &endq);
            if (endq != q) { *out = v; return true; }
            return false;
        }
    }
    return false;
}

}  // namespace

extern "C" {

// ---- ingest scanners -------------------------------------------------------

void* atn_rt_create(int32_t n_threads) { return new ThreadPool(n_threads); }

void atn_rt_destroy(void* rt) { delete static_cast<ThreadPool*>(rt); }

int32_t atn_rt_n_threads(void* rt) {
    return static_cast<ThreadPool*>(rt)->n_threads();
}

// Summarizes n_files logs on the pool, a task a file: counts_out[i*5..] =
// {n_lines, n_info, n_warn, n_error, size_bytes} and ts_out[i*2..] =
// {min_ts, max_ts} (0 when no timestamp parsed); an unreadable file gets
// zeros.  Returns the number of readable files.
int64_t atn_rt_summarize_logs(void* rt_ptr, const char* const* paths,
                              int64_t n_files, int64_t* counts_out,
                              double* ts_out) {
    ThreadPool* rt = static_cast<ThreadPool*>(rt_ptr);
    std::vector<int64_t> ok(n_files, 0);
    for (int64_t i = 0; i < n_files; ++i) {
        rt->submit([i, paths, counts_out, ts_out, &ok] {
            int64_t* c = counts_out + i * 5;
            double* ts = ts_out + i * 2;
            c[0] = c[1] = c[2] = c[3] = c[4] = 0;
            ts[0] = ts[1] = 0.0;
            const int64_t sz = read_file(paths[i]);
            if (sz < 0) return;
            ok[i] = 1;
            c[4] = sz;
            const char* p = tl_read_buf.data();
            const char* end = p + sz;
            double tmin = 0.0, tmax = 0.0;
            while (p < end) {
                const char* nl =
                    (const char*)std::memchr(p, '\n', (size_t)(end - p));
                const size_t n = nl ? (size_t)(nl - p) : (size_t)(end - p);
                ++c[0];
                const int8_t lvl = line_level(p, n);
                if (lvl < 3) ++c[1 + lvl];     // info 1, warn 2, error 3
                const double t = parse_ts(p, n);
                if (t > 0.0) {
                    if (tmin == 0.0 || t < tmin) tmin = t;
                    if (t > tmax) tmax = t;
                }
                if (!nl) break;
                p = nl + 1;
            }
            ts[0] = tmin;
            ts[1] = tmax;
        });
    }
    rt->wait_all();
    int64_t readable = 0;
    for (int64_t i = 0; i < n_files; ++i) readable += ok[i];
    return readable;
}

// Parses numeric CSV columns: for each row (the header skipped when asked;
// an empty line is no row), the requested column indices by strtod over a
// NUL-terminated copy of the field, NaN where nothing parses or the field
// is missing.  Double-quoted fields may hold commas, not newlines; a field
// holding an escaped quote ("") is NaN.  Column-major out[c * max_rows +
// r]; returns the rows parsed.
int64_t atn_scan_csv_cols(const char* text, int64_t len, const int32_t* cols,
                          int32_t n_cols, int32_t skip_header, double* out,
                          int64_t max_rows) {
    const double nan = std::nan("");
    int32_t max_col = 0;
    for (int32_t c = 0; c < n_cols; ++c)
        if (cols[c] > max_col) max_col = cols[c];
    std::vector<const char*> field_beg((size_t)max_col + 2);
    std::vector<size_t> field_len((size_t)max_col + 2);
    std::string scratch;
    int64_t row = 0;
    const char* p = text;
    const char* end = text + len;
    bool first = true;
    while (p < end && row < max_rows) {
        const char* nl = (const char*)std::memchr(p, '\n', (size_t)(end - p));
        const char* eol = nl ? nl : end;
        if (first && skip_header) {
            first = false;
            p = eol + 1;
            continue;
        }
        first = false;
        if (eol > p) {
            int32_t nf = 0;
            const char* q = p;
            while (q <= eol && nf <= max_col) {
                const char* fb = q;
                size_t fl = 0;
                if (q < eol && *q == '"') {
                    // the span keeps an escaped quote, so it parses as NaN
                    fb = ++q;
                    while (q < eol) {
                        if (*q == '"') {
                            if (q + 1 < eol && q[1] == '"') { q += 2; continue; }
                            break;
                        }
                        ++q;
                    }
                    fl = (size_t)(q - fb);
                    while (q < eol && *q != ',') ++q;
                } else {
                    while (q < eol && *q != ',') ++q;
                    fl = (size_t)(q - fb);
                }
                field_beg[nf] = fb;
                field_len[nf] = fl;
                ++nf;
                if (q >= eol) break;
                ++q;
            }
            for (int32_t c = 0; c < n_cols; ++c) {
                double v = nan;
                const size_t fl = cols[c] < nf ? field_len[cols[c]] : 0;
                if (fl > 0) {
                    const char* fb = field_beg[cols[c]];
                    if (std::memchr(fb, '"', fl) == nullptr) {
                        scratch.assign(fb, fl);
                        char* endq = nullptr;
                        const double parsed =
                            std::strtod(scratch.c_str(), &endq);
                        if (endq > scratch.c_str()) v = parsed;
                    }
                }
                out[(int64_t)c * max_rows + row] = v;
            }
            ++row;
        }
        if (!nl) break;
        p = nl + 1;
    }
    return row;
}

// Classifies each '\n'-separated line (level code as line_level) and reads
// its timestamp (parse_ts); returns the lines written (<= max_lines).
int64_t atn_scan_log(const char* text, int64_t len, int8_t* levels_out,
                     double* ts_out, int64_t max_lines) {
    int64_t count = 0;
    const char* p = text;
    const char* end = text + len;
    while (p < end && count < max_lines) {
        const char* nl = (const char*)std::memchr(p, '\n', (size_t)(end - p));
        const size_t n = nl ? (size_t)(nl - p) : (size_t)(end - p);
        levels_out[count] = line_level(p, n);
        ts_out[count] = parse_ts(p, n);
        ++count;
        if (!nl) break;
        p = nl + 1;
    }
    return count;
}

// atn_scan_log on n_threads threads from 1 MiB of text: split at len * t /
// n_threads and then after the next '\n', lines counted a chunk to place
// each chunk's output.  Below 1 MiB, or one thread, the serial scan.
int64_t atn_scan_log_mt(const char* text, int64_t len, int8_t* levels_out,
                        double* ts_out, int64_t max_lines, int32_t n_threads) {
    if (n_threads <= 1 || len < (1 << 20))
        return atn_scan_log(text, len, levels_out, ts_out, max_lines);
    std::vector<int64_t> starts{0};
    for (int t = 1; t < n_threads; ++t) {
        const int64_t pos = len * t / n_threads;
        const char* nl =
            (const char*)std::memchr(text + pos, '\n', (size_t)(len - pos));
        starts.push_back(nl ? (int64_t)(nl - text) + 1 : len);
    }
    starts.push_back(len);
    std::vector<int64_t> line_ofs(n_threads + 1, 0);
    for (int t = 0; t < n_threads; ++t) {
        int64_t c = 0;
        const char* p = text + starts[t];
        const char* endp = text + starts[t + 1];
        while (p < endp) {
            const char* nl =
                (const char*)std::memchr(p, '\n', (size_t)(endp - p));
            ++c;
            if (!nl) break;
            p = nl + 1;
        }
        line_ofs[t + 1] = line_ofs[t] + c;
    }
    const int64_t total = line_ofs[n_threads] < max_lines
                              ? line_ofs[n_threads] : max_lines;
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) {
        threads.emplace_back([=, &starts, &line_ofs]() {
            const int64_t cap =
                total - (line_ofs[t] < total ? line_ofs[t] : total);
            if (cap <= 0) return;
            atn_scan_log(text + starts[t], starts[t + 1] - starts[t],
                         levels_out + line_ofs[t], ts_out + line_ofs[t], cap);
        });
    }
    for (auto& th : threads) th.join();
    return total;
}

// Reads status_code, latency_ms and content_length from API-response JSONL
// (enhanced_openapi_monitor.py's record), a record for every line longer
// than 2 bytes, 0 for a key absent; returns the records.
int64_t atn_scan_api_jsonl(const char* text, int64_t len, int16_t* status_out,
                           float* latency_out, int32_t* clen_out,
                           int64_t max_recs) {
    int64_t count = 0;
    const char* p = text;
    const char* end = text + len;
    while (p < end && count < max_recs) {
        const char* nl = (const char*)std::memchr(p, '\n', (size_t)(end - p));
        const size_t n = nl ? (size_t)(nl - p) : (size_t)(end - p);
        if (n > 2) {
            double st = 0, lat = 0, cl = 0;
            find_num(p, n, "status_code", &st);
            find_num(p, n, "latency_ms", &lat);
            find_num(p, n, "content_length", &cl);
            status_out[count] = (int16_t)st;
            latency_out[count] = (float)lat;
            clen_out[count] = (int32_t)cl;
            ++count;
        }
        if (!nl) break;
        p = nl + 1;
    }
    return count;
}

// ---- serve tick: scratch fill ----------------------------------------------

// Fill one scratch slot of the lane kernel: sid[lanes][width] int32 and
// planes[lanes][n_planes][width] f32.
//
// Live lane i (i < n_live) is n_rows[i] spans of a C-contiguous 4-byte
// staging matrix: its row r starts at (const uint32_t*)bases[i] +
// r * strides[i] (strides in elements).  row_map[0] is the matrix row of
// sid; row_map[1 + p] the matrix row of plane p, or -1 for a plane that is
// the f32 square of plane sq_of (dur2 = dur * dur).  Row tails (j >=
// n_rows[i]) and dead lanes (i >= n_live) get sid = dead_sid and zeros.
// The result is byte-identical to the interpreter fill
// (anomod_torch/serve/batcher.py BucketRunner._fill_slot_py).
//
// Returns the words written (lanes * (1 + n_planes) * width), or -1 on
// malformed arguments (nothing is written then).
int64_t atn_stage_lanes(int32_t* sid, float* planes,
                        const void* const* bases, const int64_t* strides,
                        const int64_t* n_rows, const int32_t* row_map,
                        int32_t n_planes, int32_t sq_of, int32_t n_live,
                        int64_t lanes, int64_t width, int32_t dead_sid) {
    if (!sid || !planes || !row_map || n_planes < 1 || n_live < 0 ||
        n_live > lanes || lanes < 1 || width < 1 || sq_of < 0 ||
        sq_of >= n_planes || row_map[1 + sq_of] < 0 || row_map[0] < 0)
        return -1;
    if (n_live > 0 && (!bases || !strides || !n_rows)) return -1;
    for (int32_t i = 0; i < n_live; ++i)
        if (!bases[i] || n_rows[i] < 0 || n_rows[i] > width ||
            strides[i] < n_rows[i])
            return -1;
    for (int64_t i = 0; i < lanes; ++i) {
        const int64_t m = i < n_live ? n_rows[i] : 0;
        int32_t* s = sid + i * width;
        float* pl = planes + i * n_planes * width;
        if (m > 0) {
            const uint32_t* base = static_cast<const uint32_t*>(bases[i]);
            const int64_t stride = strides[i];
            std::memcpy(s, base + row_map[0] * stride, (size_t)m * 4);
            for (int32_t p = 0; p < n_planes; ++p) {
                float* d = pl + p * width;
                const int32_t r = row_map[1 + p];
                if (r >= 0) {
                    std::memcpy(d, base + r * stride, (size_t)m * 4);
                } else {
                    const float* x = reinterpret_cast<const float*>(
                        base + row_map[1 + sq_of] * stride);
                    for (int64_t j = 0; j < m; ++j) d[j] = x[j] * x[j];
                }
            }
        }
        std::fill(s + m, s + width, dead_sid);
        for (int32_t p = 0; p < n_planes; ++p)
            std::fill(pl + p * width + m, pl + (p + 1) * width, 0.0f);
    }
    return lanes * (1 + n_planes) * width;
}

// ---- admission-plane columnar SFQ scans -----------------------------------
//
// The pending-batch book is parallel columns: finish tag (double), admission
// seq (int64, unique), span count (int64), priority (int64) and an alive
// mask (uint8), n slots long; dead slots are skipped.
//
// Byte-parity contract with the heap engine (anomod_torch/serve/queues.py):
// - drain: alive slots sorted ascending by (fin, seq) is the drain heap's
//   pop order; the budget walk is the same sequential float64 subtraction
//   (select while remaining > 0, then remaining -= n_spans: the one-batch
//   overdraw included), so the selected set and its order are identical.
// - victim: lexicographic argmax of (pri, fin, seq) over alive slots is the
//   lazy evict heap's top (ordered by (-pri, -fin, -seq)).

// Writes the slots a drain of ``budget`` spans serves, in SFQ order, to
// out_idx; returns their count, or -1 on malformed arguments.
int64_t atn_sfq_drain(const double* fin, const int64_t* seq,
                      const int64_t* nsp, const uint8_t* alive, int64_t n,
                      double budget, int64_t* out_idx) {
    if (!fin || !seq || !nsp || !alive || !out_idx || n < 0) return -1;
    std::vector<int64_t> cand;
    cand.reserve((size_t)n);
    for (int64_t i = 0; i < n; ++i)
        if (alive[i]) cand.push_back(i);
    std::sort(cand.begin(), cand.end(), [&](int64_t a, int64_t b) {
        if (fin[a] != fin[b]) return fin[a] < fin[b];
        return seq[a] < seq[b];
    });
    double remaining = budget;
    int64_t count = 0;
    for (int64_t i : cand) {
        if (!(remaining > 0.0)) break;
        remaining -= (double)nsp[i];
        out_idx[count++] = i;
    }
    return count;
}

// The eviction candidate's slot: lexicographic max of (pri, fin, seq) over
// the alive slots; -1 when no slot is alive (or on malformed arguments).
// The caller applies the strictly-lower-priority check.
int64_t atn_sfq_victim(const double* fin, const int64_t* seq,
                       const int64_t* pri, const uint8_t* alive, int64_t n) {
    if (!fin || !seq || !pri || !alive || n < 0) return -1;
    int64_t best = -1;
    for (int64_t i = 0; i < n; ++i) {
        if (!alive[i]) continue;
        if (best < 0 || pri[i] > pri[best] ||
            (pri[i] == pri[best] &&
             (fin[i] > fin[best] ||
              (fin[i] == fin[best] && seq[i] > seq[best]))))
            best = i;
    }
    return best;
}

}  // extern "C"
