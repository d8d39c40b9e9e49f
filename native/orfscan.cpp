// Native core of the de-novo gene finder (gecco_tpu.orf.scan).
//
// The reference gets its gene-calling speed from Prodigal's C engine via
// pyrodigal (SURVEY.md §2.2); this build keeps the model/selection
// logic in Python/numpy and implements the per-nucleotide inner loops
// here: six-frame ORF candidate enumeration and in-frame hexamer
// scoring.  Bound via ctypes (gecco_tpu/orf/_native.py) with a pure
// Python fallback — both implementations are tested for equality.
//
// Build: see native/Makefile (produces gecco_tpu/orf/liborfscan.so).

#include <cstdint>
#include <cstring>

namespace {

constexpr int kStart = 1;  // candidate flag bits
constexpr int kPartialBegin = 2;
constexpr int kPartialEnd = 4;

inline bool is_stop(const int8_t* c) {
    // TAA TAG TGA with A=0 C=1 G=2 T=3
    if (c[0] != 3) return false;
    if (c[1] == 0 && (c[2] == 0 || c[2] == 2)) return true;  // TAA, TAG
    if (c[1] == 2 && c[2] == 0) return true;                 // TGA
    return false;
}

inline bool is_start(const int8_t* c) {
    // ATG GTG TTG
    return c[1] == 3 && c[2] == 2 && (c[0] == 0 || c[0] == 2 || c[0] == 3);
}

}  // namespace

extern "C" {

// Enumerate candidate genes on one strand.
//
// codes:     strand-oriented 2-bit encoding (A=0 C=1 G=2 T=3, -1 unknown)
// min_gene:  minimum gene length in nucleotides (stop included)
// max_starts: cap of alternative starts kept per stop-free region
// out_*:     preallocated arrays of capacity max_out
// returns the number of candidates written (or -1 on overflow).
int orfscan_candidates(
    const int8_t* codes, int n, int min_gene, int max_starts,
    int32_t* out_start, int32_t* out_end, uint8_t* out_flags, int max_out) {
    int count = 0;
    for (int frame = 0; frame < 3; ++frame) {
        int region_begin = frame;
        for (int i = frame; i + 2 < n + 3; i += 3) {
            bool at_end = i + 2 >= n;
            bool stop = !at_end && is_stop(codes + i);
            if (!stop && !at_end) continue;
            int region_end = at_end ? (n - (n - frame) % 3) : i;  // stop-free codons in [region_begin, region_end)
            int gene_end = stop ? region_end + 3 : region_end;
            bool partial_end = !stop;
            if (region_end - region_begin >= min_gene - 3) {
                int emitted = 0;
                // leading partial gene when the region touches the contig begin
                if (region_begin == frame) {
                    int s = region_begin;
                    if (gene_end - s >= min_gene && emitted < max_starts) {
                        if (count >= max_out) return -1;
                        uint8_t flags = 0;
                        if (!is_start(codes + s)) flags |= kPartialBegin;
                        if (partial_end) flags |= kPartialEnd;
                        out_start[count] = s;
                        out_end[count] = gene_end;
                        out_flags[count] = flags;
                        ++count;
                        ++emitted;
                    }
                }
                for (int s = region_begin; s + 2 < region_end && emitted < max_starts; s += 3) {
                    if (!is_start(codes + s)) continue;
                    if (s == region_begin && region_begin == frame) continue;  // already emitted
                    if (gene_end - s < min_gene) continue;
                    if (count >= max_out) return -1;
                    uint8_t flags = partial_end ? kPartialEnd : 0;
                    out_start[count] = s;
                    out_end[count] = gene_end;
                    out_flags[count] = flags;
                    ++count;
                    ++emitted;
                }
            }
            region_begin = region_end + (stop ? 3 : 0);
            if (at_end) break;
        }
    }
    return count;
}

// Accumulate in-frame hexamer counts over [begin, end) spans.
void orfscan_hexamer_counts(
    const int8_t* codes, int n,
    const int32_t* begins, const int32_t* ends, int nspans,
    double* counts4096) {
    for (int s = 0; s < nspans; ++s) {
        int begin = begins[s];
        int end = ends[s];
        if (end > n) end = n;
        for (int i = begin; i + 5 < end; i += 3) {
            int h = 0;
            bool ok = true;
            for (int k = 0; k < 6; ++k) {
                int8_t c = codes[i + k];
                if (c < 0) { ok = false; break; }
                h = (h << 2) | c;
            }
            if (ok) counts4096[h] += 1.0;
        }
    }
}

// Sum in-frame hexamer log-odds per candidate span [start, end).
void orfscan_score(
    const int8_t* codes, int n, const double* log_odds,
    const int32_t* starts, const int32_t* ends, int ncand,
    double* out_scores) {
    for (int c = 0; c < ncand; ++c) {
        double total = 0.0;
        int begin = starts[c];
        int end = ends[c];
        if (end > n) end = n;
        for (int i = begin; i + 5 < end; i += 3) {
            int h = 0;
            bool ok = true;
            for (int k = 0; k < 6; ++k) {
                int8_t b = codes[i + k];
                if (b < 0) { ok = false; break; }
                h = (h << 2) | b;
            }
            if (ok) total += log_odds[h];
        }
        out_scores[c] = total;
    }
}

}  // extern "C"
