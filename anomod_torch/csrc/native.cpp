// Host entries of the serve tick, in C++ with a plain C ABI (ctypes):
// the fused dispatch's scratch fill and the admission plane's columnar SFQ
// scans.  The port's own copy of the JAX package's native runtime entries
// (native/anomod_native.cpp: anomod_stage_lanes_mat, anomod_sfq_drain,
// anomod_sfq_victim), adapted to the lane kernel's scratch layout.
//
// Build (anomod_torch/io/native.py does it at first use):
//   g++ -O3 -shared -fPIC -pthread -std=c++17
// No -ffast-math: the fill writes dur^2 with one IEEE f32 multiply, the
// same rounding numpy's np.multiply gives, so the scratch is bit-exact.
//
// Every entry is a pure function over caller-owned arrays: no shared or
// static state, and ctypes releases the GIL for the whole call.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

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
