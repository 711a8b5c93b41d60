// Sanitizer hammer for the port's host library (csrc/native.cpp).
//
// Built with the whole of csrc/native.cpp under -fsanitize=thread or
// address (anomod_torch/io/sanitize.py does it) and run as a program of its
// own: a sanitized shared library cannot be loaded into an uninstrumented
// Python, so this program calls the same extern "C" entries natively, from
// N worker threads at once:
// - atn_stage_lanes into the worker's own pinned scratch slots (a slot
//   refills only after its previous fill was checked, the pipeline-slot
//   discipline), checked against a fill written here;
// - atn_sfq_drain / atn_sfq_victim on the worker's own columns, checked
//   against an O(n^2) repeated-scan oracle;
// - atn_scan_log_mt over one shared read-only text above its 1 MiB
//   threshold, at 2-4 threads, with lines across every split point;
// - atn_rt_summarize_logs on ONE pool shared by every worker (its queue,
//   wait barrier and per-worker read buffers are the race surface).
// Each scan and summary is held byte for byte to its single-threaded
// result, taken once before the workers start.
//
// Usage: hammer [workers] [iters] <dir>   (log files are written to dir)
// Exit codes: 0 clean, 2 a result differs from its oracle, 64 usage,
// anything else the sanitizer's own (TSAN_OPTIONS / ASAN_OPTIONS).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* atn_rt_create(int32_t n_threads);
void atn_rt_destroy(void* rt);
int64_t atn_rt_summarize_logs(void* rt_ptr, const char* const* paths,
                              int64_t n_files, int64_t* counts_out,
                              double* ts_out);
int64_t atn_scan_log(const char* text, int64_t len, int8_t* levels_out,
                     double* ts_out, int64_t max_lines);
int64_t atn_scan_log_mt(const char* text, int64_t len, int8_t* levels_out,
                        double* ts_out, int64_t max_lines, int32_t n_threads);
int64_t atn_stage_lanes(int32_t* sid, float* planes,
                        const void* const* bases, const int64_t* strides,
                        const int64_t* n_rows, const int32_t* row_map,
                        int32_t n_planes, int32_t sq_of, int32_t n_live,
                        int64_t lanes, int64_t width, int32_t dead_sid);
int64_t atn_sfq_drain(const double* fin, const int64_t* seq,
                      const int64_t* nsp, const uint8_t* alive, int64_t n,
                      double budget, int64_t* out_idx);
int64_t atn_sfq_victim(const double* fin, const int64_t* seq,
                       const int64_t* pri, const uint8_t* alive, int64_t n);
}

namespace {

// the serve tick's layout: 7 staged rows (replay.STAGE_KEYS), 6 scratch
// planes (ops.replay_kernels.PLANES), the last the square of plane 4
constexpr int kRows = 7;
constexpr int kPlanes = 6;
constexpr int32_t kRowMap[1 + kPlanes] = {0, 5, 3, 4, 2, 1, -1};
constexpr int32_t kSqOf = 4;

// deterministic per-thread data (no global RNG)
inline uint32_t lcg(uint32_t& s) { return s = s * 1664525u + 1013904223u; }

std::atomic<int> failures{0};

// ---- staging ----------------------------------------------------------------

void stage_worker(int tid, int iters, int depth, int32_t n_live, int64_t lanes,
                  int64_t width) {
    uint32_t seed = 0x9e3779b9u * (uint32_t)(tid + 1);
    const int32_t dead = (int32_t)(lcg(seed) % 1000u);
    std::vector<std::vector<int32_t>> sids(
        (size_t)depth, std::vector<int32_t>((size_t)(lanes * width), -7));
    std::vector<std::vector<float>> planes(
        (size_t)depth,
        std::vector<float>((size_t)(lanes * kPlanes * width), -7.0f));
    std::vector<std::vector<uint32_t>> mats((size_t)n_live);
    std::vector<const void*> bases((size_t)n_live);
    std::vector<int64_t> strides((size_t)n_live), n_rows((size_t)n_live);
    for (int it = 0; it < iters; ++it) {
        for (int32_t i = 0; i < n_live; ++i) {
            const int64_t m = (int64_t)(lcg(seed) % (uint32_t)(width + 1));
            const int64_t stride = m + (int64_t)(lcg(seed) % 5u) + 1;
            auto& mat = mats[(size_t)i];
            mat.resize((size_t)(kRows * stride));
            for (auto& v : mat) {
                // finite f32 bits in every row (the sid row reads as int32)
                const float f = (float)(int32_t)(lcg(seed) % 20001u) / 7.0f;
                std::memcpy(&v, &f, 4);
            }
            n_rows[(size_t)i] = m;
            strides[(size_t)i] = stride;
            bases[(size_t)i] = mat.data();
        }
        const size_t k = (size_t)(it % depth);
        int32_t* sid = sids[k].data();
        float* pl = planes[k].data();
        const int64_t got = atn_stage_lanes(
            sid, pl, bases.data(), strides.data(), n_rows.data(), kRowMap,
            kPlanes, kSqOf, n_live, lanes, width, dead);
        bool ok = got == lanes * (1 + kPlanes) * width;
        for (int64_t i = 0; ok && i < lanes; ++i) {
            const int64_t m = i < n_live ? n_rows[(size_t)i] : 0;
            const uint32_t* base =
                i < n_live ? mats[(size_t)i].data() : nullptr;
            const int64_t stride = i < n_live ? strides[(size_t)i] : 0;
            for (int64_t j = 0; ok && j < width; ++j) {
                int32_t want_sid = dead;
                if (j < m)
                    std::memcpy(&want_sid, base + kRowMap[0] * stride + j, 4);
                ok = sid[i * width + j] == want_sid;
                for (int p = 0; ok && p < kPlanes; ++p) {
                    float want = 0.0f;
                    if (j < m) {
                        const int32_t r = kRowMap[1 + p] >= 0
                                              ? kRowMap[1 + p]
                                              : kRowMap[1 + kSqOf];
                        std::memcpy(&want, base + r * stride + j, 4);
                        if (kRowMap[1 + p] < 0) want = want * want;
                    }
                    ok = std::memcmp(&pl[(i * kPlanes + p) * width + j],
                                     &want, 4) == 0;
                }
            }
        }
        if (!ok) ++failures;
    }
}

// ---- admission SFQ scans ------------------------------------------------------

void sfq_worker(int tid, int iters, int64_t n) {
    uint32_t seed = 0x85ebca6bu * (uint32_t)(tid + 1);
    std::vector<double> fin((size_t)n);
    std::vector<int64_t> seq((size_t)n), nsp((size_t)n), pri((size_t)n);
    std::vector<uint8_t> alive((size_t)n);
    std::vector<int64_t> out((size_t)n), want((size_t)n);
    for (int it = 0; it < iters; ++it) {
        for (int64_t i = 0; i < n; ++i) {
            fin[(size_t)i] = (double)(lcg(seed) % 4096u) / 16.0;
            seq[(size_t)i] = i;
            nsp[(size_t)i] = 1 + (int64_t)(lcg(seed) % 200u);
            pri[(size_t)i] = (int64_t)(lcg(seed) % 3u);
            alive[(size_t)i] = (uint8_t)(lcg(seed) % 4u != 0);
        }
        const double budget = (double)(lcg(seed) % 2048u) + 0.5;
        const int64_t got = atn_sfq_drain(fin.data(), seq.data(), nsp.data(),
                                          alive.data(), n, budget, out.data());
        // oracle: repeated min-scan and the same sequential budget walk
        std::vector<uint8_t> left(alive);
        double remaining = budget;
        int64_t n_want = 0;
        while (remaining > 0.0) {
            int64_t best = -1;
            for (int64_t i = 0; i < n; ++i) {
                if (!left[(size_t)i]) continue;
                if (best < 0 || fin[(size_t)i] < fin[(size_t)best] ||
                    (fin[(size_t)i] == fin[(size_t)best] &&
                     seq[(size_t)i] < seq[(size_t)best]))
                    best = i;
            }
            if (best < 0) break;
            left[(size_t)best] = 0;
            remaining -= (double)nsp[(size_t)best];
            want[(size_t)n_want++] = best;
        }
        if (got != n_want ||
            std::memcmp(out.data(), want.data(), (size_t)n_want * 8) != 0)
            ++failures;
        const int64_t v = atn_sfq_victim(fin.data(), seq.data(), pri.data(),
                                         alive.data(), n);
        int64_t vref = -1;
        for (int64_t i = 0; i < n; ++i) {
            if (!alive[(size_t)i]) continue;
            if (vref < 0 || pri[(size_t)i] > pri[(size_t)vref] ||
                (pri[(size_t)i] == pri[(size_t)vref] &&
                 (fin[(size_t)i] > fin[(size_t)vref] ||
                  (fin[(size_t)i] == fin[(size_t)vref] &&
                   seq[(size_t)i] > seq[(size_t)vref]))))
                vref = i;
        }
        if (v != vref) ++failures;
    }
}

// ---- scanners ---------------------------------------------------------------

// A log text of at least min_len bytes: timestamped lines of every level,
// lines of every length up to ~300 bytes (so lines cross each split point
// len * t / n), CRLF ends, and no '\n' at the end.
std::string log_text(size_t min_len) {
    static const char* const words[] = {"INFO", "warn", "Error", "eXcEpTiOn",
                                        "debug", "", "info: ok", "WARNING"};
    uint32_t seed = 12345u;
    std::string s;
    char head[64];
    for (int i = 0; s.size() < min_len; ++i) {
        std::snprintf(head, sizeof head, "2025-%02u-%02u %02u:%02u:%02u ",
                      1 + lcg(seed) % 13u, lcg(seed) % 32u, lcg(seed) % 25u,
                      lcg(seed) % 61u, lcg(seed) % 61u);
        if (lcg(seed) % 7u) s += head;
        s += words[lcg(seed) % 8u];
        s.append((size_t)(lcg(seed) % 300u), (char)('a' + i % 26));
        s += (lcg(seed) % 5u) ? "\n" : "\r\n";
    }
    s += "tail without a newline ERROR";
    return s;
}

struct ScanWant {
    std::vector<int8_t> levels;
    std::vector<double> ts;
};

void scan_worker(int tid, int iters, const std::string* text,
                 const ScanWant* want) {
    const int64_t cap = (int64_t)want->levels.size() + 1;
    std::vector<int8_t> lv((size_t)cap);
    std::vector<double> ts((size_t)cap);
    for (int it = 0; it < iters; ++it) {
        const int32_t n_threads = 2 + (tid + it) % 3;
        const int64_t n = atn_scan_log_mt(text->data(), (int64_t)text->size(),
                                          lv.data(), ts.data(), cap,
                                          n_threads);
        if (n != (int64_t)want->levels.size() ||
            std::memcmp(lv.data(), want->levels.data(), (size_t)n) != 0 ||
            std::memcmp(ts.data(), want->ts.data(), (size_t)n * 8) != 0)
            ++failures;
    }
}

struct SummaryWant {
    std::vector<int64_t> counts;
    std::vector<double> ts;
    int64_t readable;
};

void summary_worker(void* rt, int iters, const std::vector<const char*>* paths,
                    const SummaryWant* want) {
    const size_t n = paths->size();
    std::vector<int64_t> counts(n * 5);
    std::vector<double> ts(n * 2);
    for (int it = 0; it < iters; ++it) {
        const int64_t r = atn_rt_summarize_logs(rt, paths->data(), (int64_t)n,
                                                counts.data(), ts.data());
        if (r != want->readable || counts != want->counts ||
            std::memcmp(ts.data(), want->ts.data(), n * 16) != 0)
            ++failures;
    }
}

bool write_file(const std::string& path, const std::string& body) {
    std::FILE* f = std::fopen(path.c_str(), "wb");
    if (!f) return false;
    const bool ok = std::fwrite(body.data(), 1, body.size(), f) == body.size();
    return std::fclose(f) == 0 && ok;
}

}  // namespace

int main(int argc, char** argv) {
    if (argc < 4) {
        std::fprintf(stderr, "usage: %s workers iters dir\n", argv[0]);
        return 64;
    }
    const int n_workers = std::atoi(argv[1]);
    const int iters = std::atoi(argv[2]);
    const std::string dir = argv[3];

    // the oracles, single-threaded, before any worker starts
    const std::string text = log_text((1u << 20) + 4099u);
    ScanWant scan_want;
    scan_want.levels.resize(text.size() + 1);
    scan_want.ts.resize(text.size() + 1);
    const int64_t n_lines = atn_scan_log(text.data(), (int64_t)text.size(),
                                         scan_want.levels.data(),
                                         scan_want.ts.data(),
                                         (int64_t)text.size() + 1);
    scan_want.levels.resize((size_t)n_lines);
    scan_want.ts.resize((size_t)n_lines);

    std::vector<std::string> names;
    const std::string bodies[] = {
        text.substr(0, 300000), "", "2024-01-01 00:00:00 INFO a\nWARN b\n",
        "ERROR\r\nexception\r\n", text.substr(5000, 70000),
        "no newline at the end 1999-12-31T23:59:59 info"};
    int k = 0;
    for (const auto& body : bodies) {
        names.push_back(dir + "/log_" + std::to_string(k++) + ".log");
        if (!write_file(names.back(), body)) {
            std::fprintf(stderr, "sanitize_hammer: cannot write %s\n",
                         names.back().c_str());
            return 64;
        }
    }
    names.push_back(dir + "/missing.log");
    std::vector<const char*> paths;
    for (const auto& s : names) paths.push_back(s.c_str());
    SummaryWant sum_want{std::vector<int64_t>(paths.size() * 5),
                         std::vector<double>(paths.size() * 2), 0};
    void* solo = atn_rt_create(1);
    sum_want.readable = atn_rt_summarize_logs(
        solo, paths.data(), (int64_t)paths.size(), sum_want.counts.data(),
        sum_want.ts.data());
    atn_rt_destroy(solo);

    void* rt = atn_rt_create(3);        // the pool every worker shares
    std::vector<std::thread> ts;
    for (int t = 0; t < n_workers; ++t) {
        // small slots, and wide ones (8 lanes x 8192)
        ts.emplace_back(stage_worker, t, iters, 3, 3, 4, 64);
        ts.emplace_back(stage_worker, t + n_workers, iters / 8 + 1, 2, 6, 8,
                        8192);
        ts.emplace_back(sfq_worker, t, iters, 512);
        ts.emplace_back(scan_worker, t, iters / 8 + 1, &text, &scan_want);
        ts.emplace_back(summary_worker, rt, iters / 4 + 1, &paths, &sum_want);
    }
    for (auto& t : ts) t.join();
    atn_rt_destroy(rt);
    const int f = failures.load();
    if (f) {
        std::fprintf(stderr, "sanitize_hammer: %d results differ from their "
                     "oracles\n", f);
        return 2;
    }
    std::printf("sanitize_hammer ok\n");
    return 0;
}
