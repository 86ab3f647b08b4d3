// Native host-side kernels for the batched GPU engine.
//
// The GPU does the alignment DP; everything byte-level around it
// (FASTQ structure scan, the k-mer prefilter that decides which reads
// cross the wire, candidate gather/encode/pack, and trimmed-FASTQ
// assembly) is memory-bound host work implemented here.  Semantics
// mirror the pure-Python/NumPy implementations in
// io/chunks.py and kmer_finder.py of this package exactly
// (reference behaviour: cutadapt:src/cutadapt/_kmer_finder.pyx
// and dnaio's record chunking); the Python versions remain as
// fallbacks and as the oracle for the parity tests.
//
// Built as a plain shared library, loaded with ctypes (no pybind11 in
// this environment).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// --- FASTQ structure scan -------------------------------------------------
//
// Records are 4 lines: @head / seq / + / qual.  A missing final
// newline is tolerated (a virtual newline at end-of-buffer), CRLF line
// endings are tolerated per line.  Returns the number of records, or
//   -1  buffer does not contain a whole number of records
//   -2  a sequence and its quality line differ in length

int64_t fastq_count(const uint8_t* buf, int64_t n) {
    int64_t nl = 0;
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    while ((p = (const uint8_t*)memchr(p, '\n', end - p)) != nullptr) {
        ++nl;
        ++p;
    }
    if (nl % 4 != 0) {
        if (n > 0 && buf[n - 1] != '\n') ++nl;  // virtual final newline
        if (nl % 4 != 0) return -1;
    }
    return nl / 4;
}

int64_t fastq_parse(const uint8_t* buf, int64_t n, int64_t n_records,
                    int64_t* head_start, int64_t* head_end,
                    int64_t* seq_start, int32_t* seq_len,
                    int64_t* qual_start, int32_t* flags_out) {
    int64_t pos = 0;
    int32_t has_cr = 0;
    for (int64_t r = 0; r < n_records; ++r) {
        int64_t ls[4], le[4];
        for (int line = 0; line < 4; ++line) {
            ls[line] = pos;
            const uint8_t* nlp =
                (const uint8_t*)memchr(buf + pos, '\n', n - pos);
            int64_t lend = nlp ? (int64_t)(nlp - buf) : n;
            int64_t e = lend;
            if (e > ls[line] && buf[e - 1] == '\r') {
                --e;
                has_cr = 1;
            }
            le[line] = e;
            pos = lend + 1;
        }
        head_start[r] = ls[0] + 1;  // skip '@'
        head_end[r] = le[0];
        seq_start[r] = ls[1];
        seq_len[r] = (int32_t)(le[1] - ls[1]);
        qual_start[r] = ls[3];
        if (le[3] - ls[3] != le[1] - ls[1]) return -2;
    }
    *flags_out = has_cr;
    return n_records;
}

// --- k-mer prefilter (concatenated shift-and) -------------------------------
//
// Same predicate as KmerFinder.kmers_present, evaluated per record
// over the raw chunk buffer.  `stops` uses 0 to mean "to the end of
// the sequence".  Writes 1 into out_mask[r] iff record r needs the DP.

// `reverse` scans each sequence back-to-front (for rightmost adapter
// variants, whose k-mer sets are built against the reversed read).
static inline uint8_t kmers_hit(const uint8_t* seq, int64_t len,
                                int64_t n_entries, const int64_t* starts,
                                const int64_t* stops,
                                const uint64_t* init_masks,
                                const uint64_t* found_masks,
                                const uint64_t* masks, int32_t reverse) {
    uint8_t hit = 0;
    for (int64_t e = 0; e < n_entries && !hit; ++e) {
        int64_t start = starts[e];
        int64_t stop = stops[e];
        if (start < 0) {
            start += len;
            if (start < 0) start = 0;
        } else if (start > len) {
            continue;
        }
        if (stop < 0) {
            stop += len;
            if (stop <= 0) continue;
        } else if (stop == 0) {
            stop = len;
        }
        if (stop > len) stop = len;
        if (stop - start <= 0) continue;
        const uint64_t init = init_masks[e];
        const uint64_t found = found_masks[e];
        const uint64_t* mask = masks + e * 128;
        uint64_t rreg = 0;
        for (int64_t i = start; i < stop; ++i) {
            const uint8_t c = reverse ? seq[len - 1 - i] : seq[i];
            rreg = ((rreg << 1) | init) & (c < 128 ? mask[c] : 0);
            if (rreg & found) {
                hit = 1;
                break;
            }
        }
    }
    return hit;
}

void kmer_prefilter(const uint8_t* buf, const int64_t* seq_start,
                    const int32_t* seq_len, int64_t n_records,
                    int64_t n_entries, const int64_t* starts,
                    const int64_t* stops, const uint64_t* init_masks,
                    const uint64_t* found_masks, const uint64_t* masks,
                    int32_t reverse, uint8_t* out_mask) {
    for (int64_t r = 0; r < n_records; ++r)
        out_mask[r] = kmers_hit(buf + seq_start[r], seq_len[r], n_entries,
                                starts, stops, init_masks, found_masks,
                                masks, reverse);
}

// --- candidate gather + encode ---------------------------------------------
//
// One window of n bytes at src into a row of `width` bases (the first
// `width` bases, or the last `width` back-to-front when `reverse`),
// translated through a 256-entry LUT; pad positions are 0.

static inline void encode_row(const uint8_t* src, int64_t n, int64_t width,
                              const uint8_t* lut, int32_t reverse,
                              uint8_t* dst) {
    int64_t len = n < width ? n : width;
    if (reverse) {
        for (int64_t t = 0; t < len; ++t) dst[t] = lut[src[n - 1 - t]];
    } else {
        for (int64_t t = 0; t < len; ++t) dst[t] = lut[src[t]];
    }
    if (len < width) memset(dst + len, 0, width - len);
}

// Same, two 4-bit codes per output byte (lo nibble first): byte t holds
// code[2t] | code[2t+1] << 4; the row is width/2 bytes.  LUT values
// must be < 16.
static inline void encode_row_pack4(const uint8_t* src, int64_t n,
                                    int64_t width, const uint8_t* lut,
                                    int32_t reverse, uint8_t* dst) {
    const int64_t wp = width / 2;
    int64_t len = n < width ? n : width;
    int64_t pairs = len / 2;
    if (reverse) {
        for (int64_t t = 0; t < pairs; ++t)
            dst[t] = (uint8_t)(lut[src[n - 1 - 2 * t]] |
                               (lut[src[n - 2 - 2 * t]] << 4));
        if (len & 1) dst[pairs] = lut[src[n - len]];
    } else {
        for (int64_t t = 0; t < pairs; ++t)
            dst[t] = (uint8_t)(lut[src[2 * t]] | (lut[src[2 * t + 1]] << 4));
        if (len & 1) dst[pairs] = lut[src[len - 1]];
    }
    int64_t used = (len + 1) / 2;
    if (used < wp) memset(dst + used, 0, wp - used);
}

// Same, four 2-bit codes per output byte (lowest pair = earliest
// position); the row is width/4 bytes.  LUT values must be < 4:
// callers split off dirty windows first (window_clean).
static inline void encode_row_pack2(const uint8_t* src, int64_t n,
                                    int64_t width, const uint8_t* lut,
                                    int32_t reverse, uint8_t* dst) {
    const int64_t wp = width / 4;
    int64_t len = n < width ? n : width;
    int64_t quads = len / 4;
    if (reverse) {
        const uint8_t* end = src + n;  // read back-to-front
        for (int64_t t = 0; t < quads; ++t) {
            const uint8_t* p = end - 4 * t;
            dst[t] = (uint8_t)(lut[p[-1]] | (lut[p[-2]] << 2) |
                               (lut[p[-3]] << 4) | (lut[p[-4]] << 6));
        }
        uint8_t tail = 0;
        for (int64_t t = 4 * quads; t < len; ++t)
            tail |= (uint8_t)(lut[end[-1 - t]] << (2 * (t & 3)));
        if (len & 3) dst[quads] = tail;
    } else {
        for (int64_t t = 0; t < quads; ++t) {
            const uint8_t* p = src + 4 * t;
            dst[t] = (uint8_t)(lut[p[0]] | (lut[p[1]] << 2) |
                               (lut[p[2]] << 4) | (lut[p[3]] << 6));
        }
        uint8_t tail = 0;
        for (int64_t t = 4 * quads; t < len; ++t)
            tail |= (uint8_t)(lut[src[t]] << (2 * (t & 3)));
        if (len & 3) dst[quads] = tail;
    }
    int64_t used = (len + 3) / 4;
    if (used < wp) memset(dst + used, 0, wp - used);
}

// Gathers selected reads into a padded (n_sel, width) matrix of LUT
// codes (back-to-front when `reverse`).
void pad_encode(const uint8_t* buf, const int64_t* seq_start,
                const int32_t* seq_len, const int64_t* sel, int64_t n_sel,
                int64_t width, const uint8_t* lut, int32_t reverse,
                uint8_t* out) {
    for (int64_t i = 0; i < n_sel; ++i) {
        const int64_t r = sel[i];
        encode_row(buf + seq_start[r], seq_len[r], width, lut, reverse,
                   out + i * width);
    }
}

// Same, (n_sel, width/2) bytes of packed 4-bit codes; width even.
void pad_encode_pack4(const uint8_t* buf, const int64_t* seq_start,
                      const int32_t* seq_len, const int64_t* sel,
                      int64_t n_sel, int64_t width, const uint8_t* lut,
                      int32_t reverse, uint8_t* out) {
    for (int64_t i = 0; i < n_sel; ++i) {
        const int64_t r = sel[i];
        encode_row_pack4(buf + seq_start[r], seq_len[r], width, lut, reverse,
                         out + i * (width / 2));
    }
}

// Same, (n_sel, width/4) bytes of packed 2-bit codes; width a multiple
// of 4.
void pad_encode_pack2(const uint8_t* buf, const int64_t* seq_start,
                      const int32_t* seq_len, const int64_t* sel,
                      int64_t n_sel, int64_t width, const uint8_t* lut,
                      int32_t reverse, uint8_t* out) {
    for (int64_t i = 0; i < n_sel; ++i) {
        const int64_t r = sel[i];
        encode_row_pack2(buf + seq_start[r], seq_len[r], width, lut, reverse,
                         out + i * (width / 4));
    }
}

// The "2-bit clean" test of one window: every byte the encode would
// emit (the first `width` forward, the last `width` reversed) maps to a
// class id < 4 under `lut`, so the window can ride the 2-bit lane.
static inline bool window_clean(const uint8_t* src, int64_t len,
                                int64_t width, const uint8_t* lut,
                                int32_t reverse) {
    if (len > width) {
        if (reverse) src += len - width;
        len = width;
    }
    uint8_t dirty = 0;
    for (int64_t t = 0; t < len; ++t) dirty |= (uint8_t)(lut[src[t]] >> 2);
    return dirty == 0;
}

// --- submit's staged pass ----------------------------------------------------
//
// Two calls per dispatch of a task or upload group, each one run of C++
// with the GIL released (ctypes): stage_select picks and orders the
// candidates, stage_encode writes every dispatch batch of them into the
// engine's staging arena.

// Stable order of rows [a, b) by length, longest first (a counting sort
// over the segment's range of lengths), applied to sel, starts, lens.
static void sort_desc_by_length(int64_t a, int64_t b, int64_t* sel,
                                int64_t* starts, int32_t* lens) {
    if (b - a < 2) return;
    int32_t lo = lens[a], hi = lens[a];
    for (int64_t i = a + 1; i < b; ++i) {
        if (lens[i] < lo) lo = lens[i];
        if (lens[i] > hi) hi = lens[i];
    }
    if (lo == hi) return;
    std::vector<int64_t> pos((size_t)(hi - lo) + 1, 0);
    for (int64_t i = a; i < b; ++i) ++pos[(size_t)(hi - lens[i])];
    int64_t acc = 0;
    for (auto& p : pos) {
        const int64_t c = p;
        p = acc;
        acc += c;
    }
    const int64_t n = b - a;
    std::vector<int64_t> s_sel(n), s_starts(n);
    std::vector<int32_t> s_lens(n);
    for (int64_t i = a; i < b; ++i) {
        const int64_t j = pos[(size_t)(hi - lens[i])]++;
        s_sel[j] = sel[i];
        s_starts[j] = starts[i];
        s_lens[j] = lens[i];
    }
    memcpy(sel + a, s_sel.data(), n * sizeof(int64_t));
    memcpy(starts + a, s_starts.data(), n * sizeof(int64_t));
    memcpy(lens + a, s_lens.data(), n * sizeof(int32_t));
}

// The candidates of one dispatch over n windows (starts, lens), split
// into lanes and ordered:
// - candidates: the windows that pass the k-mer prefilter of any of
//   n_tasks tasks (kmers_hit; task t's entries are rows
//   task_entries[t] .. task_entries[t + 1] of the concatenated tables,
//   scanned back to front where task_reverse[t]); every window when
//   n_tasks is 0;
// - lanes: with clean_lut, the 2-bit-clean windows (window_clean over
//   `width`, back to front where clean_reverse) come first and the
//   others after them, where both kinds are present; the others are a
//   host tail, left in their order, where host_tail_ok and they number
//   at most max(64, n_sel >> 6);
// - with sort_desc, each lane (not the host tail) ordered by length,
//   longest first, stably.
// Writes the candidates' positions into the windows, their starts and
// their lengths in that order, and counts = {clean rows (0 without
// clean_lut), other rows, 1 if the other rows are a host tail, the
// longest length}.  Returns the number of candidates.
int64_t stage_select(const uint8_t* buf, const int64_t* starts,
                     const int32_t* lens, int64_t n, int64_t n_tasks,
                     const int64_t* task_entries,
                     const int32_t* task_reverse, const int64_t* e_starts,
                     const int64_t* e_stops, const uint64_t* init_masks,
                     const uint64_t* found_masks, const uint64_t* masks,
                     const uint8_t* clean_lut, int32_t clean_reverse,
                     int64_t width, int32_t host_tail_ok, int32_t sort_desc,
                     int64_t* out_sel, int64_t* out_starts,
                     int32_t* out_lens, int64_t* counts) {
    int64_t n_sel = 0;
    for (int64_t r = 0; r < n; ++r) {
        uint8_t hit = n_tasks == 0;
        for (int64_t t = 0; t < n_tasks && !hit; ++t) {
            const int64_t e0 = task_entries[t];
            hit = kmers_hit(buf + starts[r], lens[r],
                            task_entries[t + 1] - e0, e_starts + e0,
                            e_stops + e0, init_masks + e0, found_masks + e0,
                            masks + e0 * 128, task_reverse[t]);
        }
        if (hit) out_sel[n_sel++] = r;
    }
    int64_t n_clean = 0, n_other = n_sel, tail = 0;
    if (clean_lut != nullptr && n_sel > 0) {
        std::vector<uint8_t> clean(n_sel);
        for (int64_t i = 0; i < n_sel; ++i) {
            const int64_t r = out_sel[i];
            clean[i] = window_clean(buf + starts[r], lens[r], width,
                                    clean_lut, clean_reverse);
            n_clean += clean[i];
        }
        n_other = n_sel - n_clean;
        if (n_clean > 0 && n_other > 0) {
            std::vector<int64_t> rows(out_sel, out_sel + n_sel);
            int64_t c = 0, d = n_clean;
            for (int64_t i = 0; i < n_sel; ++i)
                out_sel[clean[i] ? c++ : d++] = rows[i];
            const int64_t cap = (n_sel >> 6) > 64 ? (n_sel >> 6) : 64;
            tail = host_tail_ok && n_other <= cap;
        }
    }
    int32_t longest = 0;
    for (int64_t i = 0; i < n_sel; ++i) {
        const int64_t r = out_sel[i];
        out_starts[i] = starts[r];
        out_lens[i] = lens[r];
        if (lens[r] > longest) longest = lens[r];
    }
    if (sort_desc) {
        if (n_clean > 0 && n_other > 0) {
            sort_desc_by_length(0, n_clean, out_sel, out_starts, out_lens);
            if (!tail)
                sort_desc_by_length(n_clean, n_sel, out_sel, out_starts,
                                    out_lens);
        } else {
            sort_desc_by_length(0, n_sel, out_sel, out_starts, out_lens);
        }
    }
    counts[0] = n_clean;
    counts[1] = n_other;
    counts[2] = tail;
    counts[3] = longest;
    return n_sel;
}

// Every dispatch batch of one staged pass, written into `arena`.
// layout holds n_batches rows of 8 int64: the batch's first row in the
// ordered candidates (c_starts, c_lens), the rows it takes, its size in
// rows (the rows past those it takes are zero), its row width in bases,
// its packing (2: four 2-bit codes a byte, 1: two 4-bit codes, 0: one
// code a base), the bytes of one wire length (1, 2 or 4: uint8, int16
// or int32), and the byte offsets in the arena of its rows and of its
// lengths (zero past the rows it takes).
void stage_encode(const uint8_t* buf, const int64_t* c_starts,
                  const int32_t* c_lens, int64_t n_batches,
                  const int64_t* layout, const uint8_t* lut, int32_t reverse,
                  uint8_t* arena) {
    for (int64_t b = 0; b < n_batches; ++b) {
        const int64_t* L = layout + 8 * b;
        const int64_t row0 = L[0], take = L[1], size = L[2], width = L[3];
        const int64_t pack = L[4], nb = L[5];
        const int64_t row_bytes =
            pack == 2 ? width / 4 : (pack == 1 ? width / 2 : width);
        uint8_t* enc = arena + L[6];
        for (int64_t i = 0; i < take; ++i) {
            const int64_t r = row0 + i;
            uint8_t* dst = enc + i * row_bytes;
            if (pack == 2)
                encode_row_pack2(buf + c_starts[r], c_lens[r], width, lut,
                                 reverse, dst);
            else if (pack == 1)
                encode_row_pack4(buf + c_starts[r], c_lens[r], width, lut,
                                 reverse, dst);
            else
                encode_row(buf + c_starts[r], c_lens[r], width, lut, reverse,
                           dst);
        }
        memset(enc + take * row_bytes, 0, (size - take) * row_bytes);
        uint8_t* lengths = arena + L[7];
        for (int64_t i = 0; i < take; ++i) {
            const int32_t v = c_lens[row0 + i];
            if (nb == 1) {
                lengths[i] = (uint8_t)v;
            } else if (nb == 2) {
                const int16_t h = (int16_t)v;
                memcpy(lengths + 2 * i, &h, 2);
            } else {
                memcpy(lengths + 4 * i, &v, 4);
            }
        }
        memset(lengths + take * nb, 0, (size - take) * nb);
    }
}

// --- trimmed FASTQ assembly --------------------------------------------------
//
// Emits '@head\nseq[:stop]\n+\nqual[:stop]\n' per record.  The caller
// computes the exact output size (sum of 6 + head_len + 2*stop) and
// provides the buffer.  Returns bytes written.

int64_t assemble_fastq(const uint8_t* buf, int64_t n_records,
                       const int64_t* head_start, const int64_t* head_end,
                       const int64_t* seq_start, const int64_t* qual_start,
                       const int64_t* stops, uint8_t* out) {
    uint8_t* dst = out;
    for (int64_t r = 0; r < n_records; ++r) {
        *dst++ = '@';
        const int64_t hl = head_end[r] - head_start[r];
        memcpy(dst, buf + head_start[r], hl);
        dst += hl;
        *dst++ = '\n';
        const int64_t stop = stops[r];
        memcpy(dst, buf + seq_start[r], stop);
        dst += stop;
        *dst++ = '\n';
        *dst++ = '+';
        *dst++ = '\n';
        memcpy(dst, buf + qual_start[r], stop);
        dst += stop;
        *dst++ = '\n';
    }
    return (int64_t)(dst - out);
}

// --- scalar semi-global aligner -----------------------------------------------
//
// The per-read hot loop of the host (fallback/oracle) path: a direct
// port of align.py Aligner.locate (itself the exact
// semantics of the reference's _align.pyx:298-587): hybrid cost/score
// DP with origin tracking, Ukkonen band, last-row candidates with the
// overlap/longer preference rules, bottom-up final-column scan with
// the reference's stale-origin comparison, early exit on exact match.
//
// `ref` and `query` arrive already translated (IUPAC/ACGT/UPPER).
// `work` is caller scratch of 3*(m+1) int32 (cost, score, origin).
// Returns 1 and fills out[6] = {ref_start, ref_stop, query_start,
// query_stop, score, errors}, or 0 for no acceptable match.

static const int32_t A_MATCH = 1, A_MISMATCH = -1, A_INS = -2, A_DEL = -2;

int32_t aligner_locate(const uint8_t* ref, int64_t m,
                       const int32_t* n_counts, int64_t effective_length,
                       double max_error_rate, int32_t flags,
                       int32_t compare_ascii, int32_t wildcard_ref,
                       int32_t indel_cost, int32_t min_overlap,
                       const uint8_t* query, int64_t n, int64_t* out,
                       int32_t* work) {
    const int start_in_reference = flags & 1;
    const int start_in_query = flags & 2;
    const int stop_in_reference = flags & 4;
    const int stop_in_query = flags & 8;
    const int64_t k = (int64_t)(max_error_rate * (double)m);

    int64_t max_n = n;
    int64_t min_n = 0;
    if (!start_in_query && n > m + k) max_n = m + k;
    if (!stop_in_query && n - m - k > 0) min_n = n - m - k;

    const int32_t del_cost = indel_cost, ins_cost = indel_cost;
    int32_t* cost = work;
    int32_t* score = work + (m + 1);
    int32_t* origin = work + 2 * (m + 1);

    if (!start_in_reference && !start_in_query) {
        for (int64_t i = 0; i <= m; ++i) {
            score[i] = (int32_t)(i * A_DEL);
            cost[i] = (int32_t)((i > min_n ? i : min_n) * del_cost);
            origin[i] = 0;
        }
    } else if (start_in_reference && !start_in_query) {
        for (int64_t i = 0; i <= m; ++i) {
            score[i] = 0;
            cost[i] = (int32_t)(min_n * del_cost);
            origin[i] = (int32_t)(min_n - i < 0 ? min_n - i : 0);
        }
    } else if (!start_in_reference && start_in_query) {
        for (int64_t i = 0; i <= m; ++i) {
            score[i] = (int32_t)(i * A_DEL);
            cost[i] = (int32_t)(i * del_cost);
            origin[i] = (int32_t)(min_n - i > 0 ? min_n - i : 0);
        }
    } else {
        for (int64_t i = 0; i <= m; ++i) {
            score[i] = 0;
            cost[i] = (int32_t)((i < min_n ? i : min_n) * del_cost);
            origin[i] = (int32_t)(min_n - i);
        }
    }

    int64_t best_ref_stop = m;
    int64_t best_query_stop = n;
    int64_t best_cost = m + n + 1;
    int32_t best_origin = 0;
    int32_t best_score = 0;

    int64_t last = k + 1 < m ? k + 1 : m;
    if (start_in_reference) last = m;
    int64_t last_filled_i = 0;
    const int32_t origin_inc = start_in_query ? 1 : 0;
    const int32_t ins_cost_inc = start_in_query ? 0 : ins_cost;
    const int32_t ins_score_inc = start_in_query ? 0 : A_INS;
    int32_t cur_origin = 0;

    for (int64_t j = min_n + 1; j <= max_n; ++j) {
        int32_t diag_cost = cost[0];
        int32_t diag_score = score[0];
        int32_t diag_origin = origin[0];
        origin[0] += origin_inc;
        cost[0] += ins_cost_inc;
        score[0] += ins_score_inc;
        const uint8_t qc = query[j - 1];
        for (int64_t i = 1; i <= last; ++i) {
            const int eq = compare_ascii ? (ref[i - 1] == qc)
                                         : ((ref[i - 1] & qc) != 0);
            int32_t cur_cost, cur_score;
            if (eq) {
                cur_cost = diag_cost;
                cur_origin = diag_origin;
                cur_score = diag_score + A_MATCH;
            } else {
                const int32_t c_diag = diag_cost + 1;
                const int32_t c_ins = cost[i] + ins_cost;
                const int32_t c_del = cost[i - 1] + del_cost;
                if (c_diag <= c_del && c_diag <= c_ins) {
                    cur_cost = c_diag;
                    cur_origin = diag_origin;
                    cur_score = diag_score + A_MISMATCH;
                } else if (c_del <= c_ins) {
                    cur_cost = c_del;
                    cur_origin = origin[i - 1];
                    cur_score = score[i - 1] + A_DEL;
                } else {
                    cur_cost = c_ins;
                    cur_origin = origin[i];
                    cur_score = score[i] + A_INS;
                }
            }
            diag_cost = cost[i];
            diag_score = score[i];
            diag_origin = origin[i];
            cost[i] = cur_cost;
            origin[i] = cur_origin;
            score[i] = cur_score;
        }
        last_filled_i = last;
        while (last >= 0 && cost[last] > k) --last;
        if (last < m) {
            ++last;
        } else if (stop_in_query) {
            const int32_t cand_cost = cost[m];
            const int32_t cand_score = score[m];
            const int32_t cand_origin = origin[m];
            cur_origin = cand_origin;
            const int64_t length =
                m + (cand_origin < 0 ? cand_origin : 0);
            int64_t cur_eff = length;
            if (wildcard_ref) {
                if (length < m)
                    cur_eff = length - (n_counts[m] - n_counts[m - length]);
                else
                    cur_eff = effective_length;
            }
            const int acceptable =
                length >= min_overlap &&
                (double)cand_cost <= (double)cur_eff * max_error_rate;
            const int64_t best_length =
                m + (best_origin < 0 ? best_origin : 0);
            if (acceptable &&
                (best_cost == m + n + 1 ||
                 (cand_origin <= best_origin + m / 2 &&
                  cand_score > best_score) ||
                 (length > best_length && cand_score > best_score))) {
                best_score = cand_score;
                best_cost = cand_cost;
                best_origin = cand_origin;
                best_ref_stop = m;
                best_query_stop = j;
                if (cand_cost == 0 && cand_origin >= 0) break;
            }
        }
    }

    if (max_n == n) {
        const int64_t first_i = stop_in_reference ? 0 : m;
        for (int64_t i = last_filled_i; i >= first_i; --i) {
            const int64_t length = i + (origin[i] < 0 ? origin[i] : 0);
            const int32_t cand_cost = cost[i];
            const int32_t cand_score = score[i];
            int64_t cur_eff = length;
            if (wildcard_ref) {
                if (length < m) {
                    const int64_t ref_start =
                        origin[i] < 0 ? -(int64_t)origin[i] : 0;
                    cur_eff = length - (n_counts[i] - n_counts[ref_start]);
                } else {
                    cur_eff = effective_length;
                }
            }
            const int acceptable =
                length >= min_overlap &&
                (double)cand_cost <= (double)cur_eff * max_error_rate;
            const int64_t best_length =
                best_ref_stop + (best_origin < 0 ? best_origin : 0);
            if (acceptable &&
                (best_cost == m + n + 1 ||
                 (cur_origin <= best_origin + m / 2 &&
                  cand_score > best_score) ||
                 (length > best_length && cand_score > best_score))) {
                best_score = cand_score;
                best_cost = cand_cost;
                best_origin = origin[i];
                best_ref_stop = i;
                best_query_stop = n;
            }
        }
    }

    if (best_cost == m + n + 1) return 0;
    out[0] = best_origin >= 0 ? 0 : -(int64_t)best_origin;  // ref_start
    out[1] = best_ref_stop;
    out[2] = best_origin >= 0 ? best_origin : 0;  // query_start
    out[3] = best_query_stop;
    out[4] = best_score;
    out[5] = best_cost;
    return 1;
}

// Single-sequence k-mer presence scan (host per-read path); same
// masks/entries as kmer_prefilter above.
int32_t kmers_present_one(const uint8_t* seq, int64_t len, int64_t n_entries,
                          const int64_t* starts, const int64_t* stops,
                          const uint64_t* init_masks,
                          const uint64_t* found_masks,
                          const uint64_t* masks) {
    for (int64_t e = 0; e < n_entries; ++e) {
        int64_t start = starts[e];
        int64_t stop = stops[e];
        if (start < 0) {
            start += len;
            if (start < 0) start = 0;
        } else if (start > len) {
            continue;
        }
        if (stop < 0) {
            stop += len;
            if (stop <= 0) continue;
        } else if (stop == 0) {
            stop = len;
        }
        if (stop > len) stop = len;
        if (stop - start <= 0) continue;
        const uint64_t init = init_masks[e];
        const uint64_t found = found_masks[e];
        const uint64_t* mask = masks + e * 128;
        uint64_t rreg = 0;
        for (int64_t i = start; i < stop; ++i) {
            const uint8_t c = seq[i];
            rreg = ((rreg << 1) | init) & (c < 128 ? mask[c] : 0);
            if (rreg & found) return 1;
        }
    }
    return 0;
}

// --- paired-read name check ---------------------------------------------------
//
// Read IDs (header up to the first ASCII whitespace) must match,
// ignoring a trailing '1'/'2'/'3' (mate-number conventions) — same
// predicate as record_names_match (io/records.py).
// Returns -1 when every pair matches, else the first offending index.

static inline bool is_space(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
           c == '\f';
}

// Returns the [start, end) of the read ID within the header: the first
// whitespace-delimited token (leading whitespace skipped, mirroring
// str.split() in record_names_match), minus a trailing mate number.
static inline void id_span(const uint8_t* h, int64_t n, int64_t* start,
                           int64_t* end) {
    int64_t i = 0;
    while (i < n && is_space(h[i])) ++i;
    *start = i;
    while (i < n && !is_space(h[i])) ++i;
    if (i > *start) {
        const uint8_t last = h[i - 1];
        if (last == '1' || last == '2' || last == '3') --i;
    }
    *end = i;
}

int64_t check_pair_names(const uint8_t* buf1, const int64_t* hs1,
                         const int64_t* he1, const uint8_t* buf2,
                         const int64_t* hs2, const int64_t* he2,
                         int64_t n_records) {
    for (int64_t r = 0; r < n_records; ++r) {
        const uint8_t* h1 = buf1 + hs1[r];
        const uint8_t* h2 = buf2 + hs2[r];
        int64_t s1, e1, s2, e2;
        id_span(h1, he1[r] - hs1[r], &s1, &e1);
        id_span(h2, he2[r] - hs2[r], &s2, &e2);
        if (e1 - s1 != e2 - s2 ||
            memcmp(h1 + s1, h2 + s2, e1 - s1) != 0)
            return r;
    }
    return -1;
}

// --- quality / poly-A trimming scans -----------------------------------------
//
// Exact reference semantics (qualtrim.pyx / qualtrim.py),
// evaluated per read over the current [win_start, win_stop) window of
// each record. Outputs are window-relative trim offsets applied as
// new absolute windows by the caller.

// BWA quality trim. cutoff_front < 0 disables the 5' pass,
// cutoff_back < 0 disables the 3' pass. Window collapse -> empty
// window at the original start (start == stop == 0 relative).
void quality_trim(const uint8_t* buf, const int64_t* qual_start,
                  const int32_t* win_start, const int32_t* win_stop,
                  int64_t n_records, int32_t cutoff_front,
                  int32_t cutoff_back, int32_t base, int32_t* out_start,
                  int32_t* out_stop) {
    for (int64_t r = 0; r < n_records; ++r) {
        const uint8_t* q = buf + qual_start[r] + win_start[r];
        const int64_t n = win_stop[r] - win_start[r];
        int64_t start = 0, stop = n;
        if (cutoff_front >= 0) {
            int64_t s = 0, max_qual = 0;
            for (int64_t i = 0; i < n; ++i) {
                s += cutoff_front - ((int64_t)q[i] - base);
                if (s < 0) break;
                if (s > max_qual) {
                    max_qual = s;
                    start = i + 1;
                }
            }
        }
        if (cutoff_back >= 0) {
            int64_t s = 0, max_qual = 0;
            for (int64_t i = n - 1; i >= 0; --i) {
                s += cutoff_back - ((int64_t)q[i] - base);
                if (s < 0) break;
                if (s > max_qual) {
                    max_qual = s;
                    stop = i;
                }
            }
        }
        if (start >= stop) {
            start = 0;
            stop = 0;
        }
        out_start[r] = (int32_t)start;
        out_stop[r] = (int32_t)stop;
    }
}

// NextSeq 3' trim: like the 3' pass above but G bases count as
// quality (cutoff - 1). Returns the window-relative stop.
void nextseq_trim(const uint8_t* buf, const int64_t* seq_start,
                  const int64_t* qual_start, const int32_t* win_start,
                  const int32_t* win_stop, int64_t n_records, int32_t cutoff,
                  int32_t base, int32_t* out_stop) {
    for (int64_t r = 0; r < n_records; ++r) {
        const uint8_t* sq = buf + seq_start[r] + win_start[r];
        const uint8_t* q = buf + qual_start[r] + win_start[r];
        const int64_t n = win_stop[r] - win_start[r];
        int64_t s = 0, max_qual = 0, max_i = n;
        for (int64_t i = n - 1; i >= 0; --i) {
            int64_t qv = (int64_t)q[i] - base;
            if (sq[i] == 'G') qv = cutoff - 1;
            s += cutoff - qv;
            if (s < 0) break;
            if (s > max_qual) {
                max_qual = s;
                max_i = i;
            }
        }
        out_stop[r] = (int32_t)max_i;
    }
}

// Poly-A tail (revcomp=0: 'A' tail at the 3' end, returns
// window-relative tail start) or poly-T head (revcomp=1: returns
// window-relative head end). Max error rate 0.2, min length 3.
void poly_a_trim(const uint8_t* buf, const int64_t* seq_start,
                 const int32_t* win_start, const int32_t* win_stop,
                 int64_t n_records, int32_t revcomp, int32_t* out_index) {
    for (int64_t r = 0; r < n_records; ++r) {
        const uint8_t* s = buf + seq_start[r] + win_start[r];
        const int64_t n = win_stop[r] - win_start[r];
        int64_t best_score = 0, score = 0, errors = 0, best_index;
        if (revcomp) {
            best_index = 0;
            for (int64_t i = 0; i < n; ++i) {
                if (s[i] == 'T') {
                    score += 1;
                } else {
                    score -= 2;
                    ++errors;
                }
                if (score > best_score && errors * 5 <= i + 1) {
                    best_score = score;
                    best_index = i + 1;
                }
            }
            if (best_index < 3) best_index = 0;
        } else {
            best_index = n;
            for (int64_t i = n - 1; i >= 0; --i) {
                if (s[i] == 'A') {
                    score += 1;
                } else {
                    score -= 2;
                    ++errors;
                }
                if (score > best_score && errors * 5 <= n - i) {
                    best_score = score;
                    best_index = i;
                }
            }
            if (best_index > n - 3) best_index = n;
        }
        out_index[r] = (int32_t)best_index;
    }
}

// --- filter predicate scans ----------------------------------------------------

// Expected errors per window: 4-lane summation over a caller-provided
// 94-entry phred->error-probability table (float64, exactly the host
// engine's accumulation order — qualtrim.py expected_errors /
// reference expected_errors.h:103-140). Writes -1.0 for any window
// containing an invalid phred; the caller re-runs those through the
// host path so the error message is identical.
void expected_errors_win(const uint8_t* buf, const int64_t* qual_start,
                         const int32_t* win_start, const int32_t* win_stop,
                         int64_t n_records, int32_t base,
                         const double* table, double* out) {
    const int32_t max_phred = 126 - base;
    for (int64_t r = 0; r < n_records; ++r) {
        const uint8_t* q = buf + qual_start[r] + win_start[r];
        const int64_t n = win_stop[r] - win_start[r];
        double e0 = 0.0, e1 = 0.0, e2 = 0.0, e3 = 0.0;
        int64_t i = 0;
        int bad = 0;
        for (; i + 4 <= n; i += 4) {
            const int32_t p0 = (int32_t)q[i] - base;
            const int32_t p1 = (int32_t)q[i + 1] - base;
            const int32_t p2 = (int32_t)q[i + 2] - base;
            const int32_t p3 = (int32_t)q[i + 3] - base;
            if (p0 < 0 || p0 > max_phred || p1 < 0 || p1 > max_phred ||
                p2 < 0 || p2 > max_phred || p3 < 0 || p3 > max_phred) {
                bad = 1;
                break;
            }
            e0 += table[p0];
            e1 += table[p1];
            e2 += table[p2];
            e3 += table[p3];
        }
        if (!bad) {
            for (; i < n; ++i) {
                const int32_t p = (int32_t)q[i] - base;
                if (p < 0 || p > max_phred) {
                    bad = 1;
                    break;
                }
                e0 += table[p];
            }
        }
        out[r] = bad ? -1.0 : (e0 + e1 + e2 + e3);
    }
}

// Number of 'N'/'n' bases per window.
void count_n(const uint8_t* buf, const int64_t* seq_start,
             const int32_t* win_start, const int32_t* win_stop,
             int64_t n_records, int32_t* out) {
    for (int64_t r = 0; r < n_records; ++r) {
        const uint8_t* s = buf + seq_start[r] + win_start[r];
        const int64_t n = win_stop[r] - win_start[r];
        int32_t c = 0;
        for (int64_t i = 0; i < n; ++i)
            c += (s[i] == 'N' || s[i] == 'n');
        out[r] = c;
    }
}

// CASAVA filter flag: header 'xxxx x:Y:x:x' — the three bytes after
// the first character following the first space must be ':Y:'.
void casava_filtered(const uint8_t* buf, const int64_t* head_start,
                     const int64_t* head_end, int64_t n_records,
                     uint8_t* out) {
    for (int64_t r = 0; r < n_records; ++r) {
        const uint8_t* h = buf + head_start[r];
        const int64_t n = head_end[r] - head_start[r];
        const uint8_t* sp = (const uint8_t*)memchr(h, ' ', n);
        uint8_t flag = 0;
        if (sp != nullptr) {
            const int64_t rest = n - (sp - h) - 1;  // after the space
            if (rest >= 4)
                flag = sp[2] == ':' && sp[3] == 'Y' && sp[4] == ':';
        }
        out[r] = flag;
    }
}

// Trim uppercase 'N' runs from both window ends (NEndTrimmer,
// reference modifiers.py:902-918). Outputs window-relative start/stop.
void trim_n_ends(const uint8_t* buf, const int64_t* seq_start,
                 const int32_t* win_start, const int32_t* win_stop,
                 int64_t n_records, int32_t* out_start, int32_t* out_stop) {
    for (int64_t r = 0; r < n_records; ++r) {
        const uint8_t* s = buf + seq_start[r] + win_start[r];
        const int64_t n = win_stop[r] - win_start[r];
        int64_t a = 0;
        while (a < n && s[a] == 'N') ++a;
        int64_t b = n;
        while (b > 0 && s[b - 1] == 'N') --b;
        if (b < a) b = a;  // all-N read -> empty window
        out_start[r] = (int32_t)a;
        out_stop[r] = (int32_t)b;
    }
}

// --- windowed trimmed-FASTQ assembly with keep mask --------------------------
//
// Emits '@head\nseq[start:stop]\n+\nqual[start:stop]\n' for records
// with keep[r] != 0. Caller precomputes the exact output size.

int64_t assemble_fastq_window(const uint8_t* buf, int64_t n_records,
                              const int64_t* head_start,
                              const int64_t* head_end,
                              const int64_t* seq_start,
                              const int64_t* qual_start,
                              const int32_t* win_start,
                              const int32_t* win_stop, const uint8_t* keep,
                              uint8_t* out) {
    uint8_t* dst = out;
    for (int64_t r = 0; r < n_records; ++r) {
        if (!keep[r]) continue;
        *dst++ = '@';
        const int64_t hl = head_end[r] - head_start[r];
        memcpy(dst, buf + head_start[r], hl);
        dst += hl;
        *dst++ = '\n';
        const int64_t len = win_stop[r] - win_start[r];
        memcpy(dst, buf + seq_start[r] + win_start[r], len);
        dst += len;
        *dst++ = '\n';
        *dst++ = '+';
        *dst++ = '\n';
        memcpy(dst, buf + qual_start[r] + win_start[r], len);
        dst += len;
        *dst++ = '\n';
    }
    return (int64_t)(dst - out);
}

// Reverse-complement every record's sequence bytes and reverse its
// quality bytes, in place (callers operate on a copy of the chunk).
// `comp` is the 256-byte complement table (IUPAC-aware, case kept).
void reverse_complement_records(uint8_t* buf, int64_t n_records,
                                const int64_t* seq_start,
                                const int32_t* seq_len,
                                const int64_t* qual_start,
                                const uint8_t* comp) {
    for (int64_t r = 0; r < n_records; ++r) {
        const int64_t n = seq_len[r];
        uint8_t* s = buf + seq_start[r];
        for (int64_t i = 0, j = n - 1; i < j; ++i, --j) {
            const uint8_t a = comp[s[i]], b = comp[s[j]];
            s[i] = b;
            s[j] = a;
        }
        if (n & 1) s[n / 2] = comp[s[n / 2]];
        uint8_t* q = buf + qual_start[r];
        for (int64_t i = 0, j = n - 1; i < j; ++i, --j) {
            const uint8_t t = q[i];
            q[i] = q[j];
            q[j] = t;
        }
    }
}

// Windowed assembly choosing per record between the forward chunk and
// its reverse-complemented copy (same offsets); rc records get
// `suffix` appended to their header (--revcomp's " rc").
int64_t assemble_fastq_window_rc(
    const uint8_t* buf, const uint8_t* rc_buf, int64_t n_records,
    const int64_t* head_start, const int64_t* head_end,
    const int64_t* seq_start, const int64_t* qual_start,
    const int32_t* win_start, const int32_t* win_stop,
    const uint8_t* keep, const uint8_t* is_rc, const uint8_t* suffix,
    int64_t suffix_len, uint8_t* out) {
    uint8_t* dst = out;
    for (int64_t r = 0; r < n_records; ++r) {
        if (!keep[r]) continue;
        const uint8_t* src = is_rc[r] ? rc_buf : buf;
        *dst++ = '@';
        const int64_t hl = head_end[r] - head_start[r];
        memcpy(dst, buf + head_start[r], hl);
        dst += hl;
        if (is_rc[r] && suffix_len) {
            memcpy(dst, suffix, suffix_len);
            dst += suffix_len;
        }
        *dst++ = '\n';
        const int64_t ws = win_start[r];
        const int64_t len = win_stop[r] - ws;
        memcpy(dst, src + seq_start[r] + ws, len);
        dst += len;
        *dst++ = '\n';
        *dst++ = '+';
        *dst++ = '\n';
        memcpy(dst, src + qual_start[r] + ws, len);
        dst += len;
        *dst++ = '\n';
    }
    return (int64_t)(dst - out);
}

// Full-length assembly with a remainder-interval transform, for the
// 'mask' (mode 1: N outside [rem_start, rem_stop)) and 'lowercase'
// (mode 2: upper inside, lower outside) adapter actions
// (reference modifiers.py:163-189). Reads keep their full length.
int64_t assemble_fastq_transform(const uint8_t* buf, int64_t n_records,
                                 const int64_t* head_start,
                                 const int64_t* head_end,
                                 const int64_t* seq_start,
                                 const int64_t* qual_start,
                                 const int32_t* win_start,
                                 const int32_t* win_stop,
                                 const int32_t* rem_start,
                                 const int32_t* rem_stop,
                                 const uint8_t* keep, int32_t mode,
                                 uint8_t* out) {
    uint8_t* dst = out;
    for (int64_t r = 0; r < n_records; ++r) {
        if (!keep[r]) continue;
        *dst++ = '@';
        const int64_t hl = head_end[r] - head_start[r];
        memcpy(dst, buf + head_start[r], hl);
        dst += hl;
        *dst++ = '\n';
        const int64_t ws = win_start[r], we = win_stop[r];
        const uint8_t* s = buf + seq_start[r];
        const int64_t a = rem_start[r], b = rem_stop[r];
        if (mode == 1) {  // mask
            for (int64_t i = ws; i < we; ++i)
                *dst++ = (i >= a && i < b) ? s[i] : 'N';
        } else {  // lowercase
            for (int64_t i = ws; i < we; ++i) {
                uint8_t c = s[i];
                if (i >= a && i < b) {
                    if (c >= 'a' && c <= 'z') c -= 32;
                } else {
                    if (c >= 'A' && c <= 'Z') c += 32;
                }
                *dst++ = c;
            }
        }
        *dst++ = '\n';
        *dst++ = '+';
        *dst++ = '\n';
        memcpy(dst, buf + qual_start[r] + ws, we - ws);
        dst += we - ws;
        *dst++ = '\n';
    }
    return (int64_t)(dst - out);
}

}  // extern "C"
