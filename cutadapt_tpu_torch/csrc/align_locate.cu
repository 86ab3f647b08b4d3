// Banded semi-global aligner for Hopper (sm_90a): a wavefront of lanes per
// read.
//
// Replaces the Pallas TPU kernel cutadapt_tpu/ops/align_pallas.py:
// make_pallas_locate (kernel body :134-459, pl.pallas_call :468) in both
// of its lanes: BITS=2 reads four 2-bit query class ids per byte (lowest
// pair = earliest column), BITS=4 two 4-bit ids per byte (low nibble
// first). BITS=8, the byte lane, replaces the byte use of the XLA
// aligner cutadapt_tpu/ops/align_batch.py:make_batch_locate
// (packed=False): adapters that need more than 16 query classes, which
// are always compared as ASCII. It reads one query_lut code per byte and
// tests a match as the code's equality with the row's reference code
// (encode_reference) where the packed lanes look the class up in the
// row's class bitmask. Results are the same packed (2, B) int32 words:
//   row 0 = query_start | query_stop << 14 | found << 28
//   row 1 = errors | (score + 32768) << 16
// or, in wide mode (Params::wide), the unpacked (7, B) int32 rows
//   found, query_start, query_stop, errors, score, ref_start, ref_stop
// of the JAX engine's wide format (cutadapt_tpu/batch_pipeline.py:
// _make_locate_step(wide=True)): windows of 2**14 bp or more, whose
// coordinates overflow the 14-bit fields, and adapter-side coordinates
// (--wildcard-file). The DP keeps every coordinate in int32 either way;
// only the final store differs, so one instantiation serves both modes.
//
// What bounds it: integer ALU work per DP cell. A read moves 25-50 bytes
// in and 8 bytes out, but its DP touches (m+1) cells per active column,
// each 24 to 32 integer operations (key compares, selects, adds; the
// count is in chip_smoke.py), so a large launch sits far on the
// operations side of the card's roofline. A small launch (a few thousand
// reads) cannot fill the card, and there the length of one read's chain
// of dependent cells bounds it: the deletion cascade makes each cell of a
// column wait for the cell above it, and each column wait for the last.
//
// What the design does about it:
// - A group of L lanes (8, 16 or 32 adjacent threads of a warp) holds one
//   read. Lane l owns rows [l*r, l*r + r) of the (m+1)-row DP column, row 0
//   on lane 0, r = ceil((m+1)/L), and keeps their cost, score and origin in
//   registers: r and L are template arguments, every row index is a
//   compile-time constant after unrolling, and no cell loads or stores the
//   DP column.
// - The group walks anti-diagonals: lane l runs column j at step j + l.
//   At each step it receives from lane l-1 (__shfl_up_sync within the
//   group) the new cascade value of the row above its block at column j,
//   with the column's query class id (only lane 0 reads the packed row),
//   takes the diagonal of its first row from what it received one step
//   before, runs its r cells in sequence and hands its bottom row on. A
//   read's chain is (columns + lanes - 1) steps of r cells instead of
//   columns x m cells, and a launch has L threads per read.
// - The band is resolved late, in the lane that holds row m. Ukkonen's
//   fill_end for column j is `last` of column j-1, known only there and
//   only after the upper lanes have already run column j. So each lane
//   ORs the bits of its rows whose new cost is <= k into a row mask that
//   travels down with the cascade value (ceil(L*r/64) 64-bit words), and
//   the last lane takes `shrunk` as the highest set bit at or below
//   fill_end, then `last`, `last_filled` and the last-row candidate as
//   before. The stale origin is the origin at row fill_end of the last
//   column whose fill_end >= 1. Row 0's cost never falls, so fill_end >= 1
//   holds on a prefix of the columns: if it holds at the final column,
//   that origin is in the final column (row last_filled). Otherwise
//   last_filled is 0 and row 0's cost is above k there, so the final scan
//   reaches only row 0 and rejects it (a cost above k needs an infinite
//   minimum length): the stale origin is never read, and the results are
//   the same on every field.
// - Groups of one warp differ in read length and in min_n. The warp runs
//   to its longest group (a warp-wide max of columns + lanes - 1), and a
//   lane idles at steps outside its group's columns, so the shuffles stay
//   full-warp; a padding read of length 0 does no work. So a long read
//   (30 kb) holds the other 1-3 reads of its warp for its 30k steps; the
//   engine's length sort of each lane's candidates on CUDA puts reads of
//   similar length in one warp.
// - After the last column, lanes stage their rows in shared memory and the
//   last lane runs the bottom-up final-column scan, once per read.
// - Adapters with more than 256 DP rows use L = 32 and a runtime r, with
//   each lane's rows and row mask in shared memory ([q][c,s,o][thread],
//   no bank conflicts), or, past what a block's shared memory holds
//   (about 3,600 rows), in a device scratch buffer of the same layout.
//   The variant follows from m alone (ops/align_cuda.py:kernel_layout).
//
// Semantics are those of the TPU kernel, including the lexicographic
// (cost, class, pos) tie-breaks of _key_min, cost saturation at INF_COST,
// Ukkonen's `last` (it gates the candidate test, `last_filled` and the
// stale origin; no row is pruned), `done` (stops last-row candidate
// updates only) and the bottom-up final-column scan. Each cell is the
// same recurrence as in the earlier one-thread-per-read kernel, and the
// cascade still runs down the rows of a column in order, so every tie
// has the same winner. The TPU kernel cuts its ladder at ceil(log2(k+2))
// passes; the full sequential cascade here can differ from that only in
// cells whose cost is above k, which no accepted alignment reads, so
// `found` agrees everywhere and the other fields agree wherever a match
// was found.
//
// The byte lane moves 4x the 2-bit lane's bytes per base, still far below
// the card's memory rate for the work each byte carries. A byte-lane
// adapter has at least 16 distinct letters, so m >= 16 and the lane
// instantiates only the layouts kernel_layout picks from there on (no
// 8 x 1 or 8 x 2 register variant).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see ops/align_cuda.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInfCost = 1 << 28;
constexpr int32_t kBigNeg = -(1 << 28);
constexpr int32_t kMatchScore = 1;
constexpr int32_t kMismatchScore = -1;
constexpr int32_t kInsertionScore = -2;
constexpr int32_t kDeletionScore = -2;
constexpr int kThreads = 128;
constexpr unsigned kFullWarp = 0xffffffffu;
// The tie-break (class, pos) of a cell as one word: class 1 adds kClass1,
// so that class 0 (pos -i) < class 1 (pos +i or BIG_NEG) and, within a
// class, pos orders as before. |pos| < 2^29, so the lexicographic order
// of (class, pos) and the order of the word are the same.
constexpr int32_t kClass1 = 1 << 30;
constexpr int32_t kSeedTie = kClass1 + kBigNeg;

// where a lane keeps its rows
enum Mode { kRegisters = 0, kShared = 1, kScratch = 2 };

struct Params {
  int B;            // reads
  int Wp;           // bytes per packed row
  int m;            // reference length
  int k;            // int(max_error_rate * m)
  int flags;        // EndSkip flags (1: start in ref, 2: start in query,
                    // 4: stop in ref, 8: stop in query)
  int indel_cost;
  int min_overlap;
  int eff_len;      // effective reference length (N excluded)
  int wildcard_ref;
  int n_minlen;     // entries of the minimum-length table (k + 2)
  int rows;         // rows per lane (kShared, kScratch)
  int wide;         // store the unpacked (7, B) rows instead of (2, B)
};

// One DP cell's key (cost, tie = (class, pos) as one word) and payload
// (score, origin).
struct Cell {
  int32_t c, t, s, o;
};

// _key_min: a wins on a lexicographically smaller-or-equal key (cost,
// class, pos). Selects field by field and returns by value, so the cells
// stay in registers.
__device__ __forceinline__ Cell key_min(const Cell a, const Cell b) {
  const bool a_wins = a.c < b.c || (a.c == b.c && a.t <= b.t);
  Cell r;
  r.c = a_wins ? a.c : b.c;
  r.t = a_wins ? a.t : b.t;
  r.s = a_wins ? a.s : b.s;
  r.o = a_wins ? a.o : b.o;
  return r;
}

// Row i >= 1 of a column: `run` is the new row i-1 (the deletion
// cascade), (dc, ds, dor) the old row i-1 (diagonal), (pc, ps, po) the
// old row i (insertion). Returns the new row i.
__device__ __forceinline__ Cell dp_cell(const Cell run, int32_t dc,
                                        int32_t ds, int32_t dor, int32_t pc,
                                        int32_t ps, int32_t po, bool eq,
                                        int i, int ins_cost, int del_cost) {
  const Cell diag = {eq ? dc : dc + 1, -i,
                     ds + (eq ? kMatchScore : kMismatchScore), dor};
  Cell leaf = diag;
  if (!eq) {
    const Cell ins = {pc + ins_cost, kClass1 + i, ps + kInsertionScore, po};
    leaf = key_min(diag, ins);
  }
  // a deletion into a matching row costs INF (it takes the diagonal)
  const Cell del = {min(run.c + (eq ? kInfCost : del_cost), kInfCost),
                    run.t, run.s + kDeletionScore, run.o};
  return key_min(leaf, del);
}

// Row i of the initial column (align_pallas.py:233-249).
__device__ __forceinline__ void init_row(int i, int min_n, bool start_in_ref,
                                         bool start_in_query, int del_cost,
                                         int32_t& c, int32_t& s, int32_t& o) {
  if (!start_in_ref && !start_in_query) {
    s = i * kDeletionScore;
    c = max(i, min_n) * del_cost;
    o = 0;
  } else if (start_in_ref && !start_in_query) {
    s = 0;
    c = min_n * del_cost;
    o = min(0, min_n - i);
  } else if (!start_in_ref && start_in_query) {
    s = i * kDeletionScore;
    c = i * del_cost;
    o = max(0, min_n - i);
  } else {
    s = 0;
    c = min(i, min_n) * del_cost;
    o = min_n - i;
  }
}

// Bits of rows 64w .. min(fill_end, 64w + 63) of mask word w.
__device__ __forceinline__ unsigned long long rows_upto(int fill_end, int w) {
  const int d = fill_end - 64 * w;
  return d < 0 ? 0ull : d >= 63 ? ~0ull : (2ull << d) - 1ull;
}

// L lanes per read; RR rows per lane in registers (MODE kRegisters) or
// p.rows rows per lane in memory (kShared, kScratch; L = 32).
template <int BITS, int L, int RR, int MODE>
__global__ void __launch_bounds__(kThreads)
locate_kernel(const uint8_t* __restrict__ enc,
              const int32_t* __restrict__ lengths,
              const int32_t* __restrict__ tables,
              int32_t* __restrict__ out,
              int32_t* __restrict__ scratch,
              Params p) {
  constexpr bool REG = MODE == kRegisters;
  constexpr int RA = REG ? RR : 1;  // register array length
  constexpr int NW = REG ? (L * RR + 63) / 64 : 1;  // register mask words
  constexpr int kPerByte = 8 / BITS;
  constexpr int kMask = (1 << BITS) - 1;
  extern __shared__ __align__(16) int32_t smem[];

  const int m = p.m;
  const int R = m + 1;
  const int k = p.k;
  const int r = REG ? RR : p.rows;
  const int nw = REG ? NW : (L * r + 63) / 64;
  const int lane = threadIdx.x % L;        // rank in the group
  const int group = threadIdx.x / L;       // group in the block
  const int b = blockIdx.x * (kThreads / L) + group;
  const int lm = m / r;                    // the lane that holds row m
  const int row0 = lane * r;               // this lane's first row
  const bool valid = b < p.B;

  const bool start_in_ref = p.flags & 1;
  const bool start_in_query = p.flags & 2;
  const bool stop_in_ref = p.flags & 4;
  const bool stop_in_query = p.flags & 8;
  const int ins_cost = p.indel_cost;
  const int del_cost = p.indel_cost;
  const int origin_increment = start_in_query ? 1 : 0;
  const int ins_cost_inc = start_in_query ? 0 : ins_cost;
  const int ins_score_inc = start_in_query ? 0 : kInsertionScore;
  const int cost_cap = p.n_minlen - 1;
  const int half_m = m / 2;
  const int32_t* ncnt = tables + m;
  const int32_t* minlen = tables + m + R;

  const int n = valid ? __ldg(lengths + b) : 0;
  const int max_n = start_in_query ? n : min(n, m + k);
  const int min_n = stop_in_query ? 0 : max(0, n - m - k);
  const int j_end = min(max_n, p.Wp * kPerByte);
  const int n_cols = valid ? max(0, j_end - min_n) : 0;
  const int steps = __reduce_max_sync(kFullWarp, n_cols > 0 ? n_cols + lm : 0);
  const uint8_t* row = enc + (size_t)(valid ? b : 0) * p.Wp;

  // this lane's rows: registers, or [q][c,s,o][thread] in memory followed
  // by the row mask [w][thread]
  int32_t C[RA], S[RA], O[RA], RM[RA];
  unsigned long long mk[NW];
  int32_t* base = nullptr;
  unsigned long long* mem_mask = nullptr;
  if constexpr (!REG) {
    base = MODE == kShared
               ? smem
               : scratch + (size_t)blockIdx.x * kThreads * (3 * r + 2 * nw);
    mem_mask = reinterpret_cast<unsigned long long*>(base + 3 * r * kThreads) +
               threadIdx.x;
  }
  auto Cq = [&](int q) -> int32_t& {
    if constexpr (REG) return C[q];
    else return base[(3 * q) * kThreads + threadIdx.x];
  };
  auto Sq = [&](int q) -> int32_t& {
    if constexpr (REG) return S[q];
    else return base[(3 * q + 1) * kThreads + threadIdx.x];
  };
  auto Oq = [&](int q) -> int32_t& {
    if constexpr (REG) return O[q];
    else return base[(3 * q + 2) * kThreads + threadIdx.x];
  };
  auto Mw = [&](int w) -> unsigned long long& {
    if constexpr (REG) return mk[w];
    else return mem_mask[(size_t)w * kThreads];
  };

#pragma unroll
  for (int q = 0; q < r; ++q) {
    const int i = row0 + q;
    int32_t c = 0, s = 0, o = 0;
    if (i <= m) init_row(i, min_n, start_in_ref, start_in_query, del_cost, c, s, o);
    Cq(q) = c;
    Sq(q) = s;
    Oq(q) = o;
    if constexpr (REG) RM[q] = (i >= 1 && i <= m) ? __ldg(tables + i - 1) : 0;
  }
#pragma unroll
  for (int w = 0; w < nw; ++w) Mw(w) = 0;

  // old value of the row above this lane's block (its first row's
  // diagonal), from the initial column
  int32_t up_c = 0, up_s = 0, up_o = 0;
  if (lane > 0 && row0 - 1 <= m)
    init_row(row0 - 1, min_n, start_in_ref, start_in_query, del_cost, up_c,
             up_s, up_o);

  Cell run = {0, 0, 0, 0};  // this lane's bottom row, new, last column
  int qc_out = 0;

  // band and best state (meaningful in lane lm)
  int last = start_in_ref ? m : min(m, k + 1);
  int last_filled = 0;
  bool best_found = false;
  int32_t best_cost = kInfCost, best_score = 0, best_origin = 0;
  int32_t best_ref_stop = m, best_query_stop = 0;
  bool done = false;

  for (int t = 0; t < steps; ++t) {
    // what lane-1 produced at step t-1: row0-1 of column t - lane
    Cell in;
    in.c = __shfl_up_sync(kFullWarp, run.c, 1, L);
    in.t = __shfl_up_sync(kFullWarp, run.t, 1, L);
    in.s = __shfl_up_sync(kFullWarp, run.s, 1, L);
    in.o = __shfl_up_sync(kFullWarp, run.o, 1, L);
    const int qc_in = __shfl_up_sync(kFullWarp, qc_out, 1, L);
#pragma unroll
    for (int w = 0; w < nw; ++w) Mw(w) = __shfl_up_sync(kFullWarp, Mw(w), 1, L);

    const int col = t - lane;
    if (lane > lm || col < 0 || col >= n_cols) continue;
    const int j = min_n + 1 + col;

    int qc;
    int32_t dc, ds, dor;  // old row i-1
    uint32_t own = 0;     // kRegisters: bit q = new cost of row0+q <= k
    if (lane == 0) {
      const int q = j - 1;
      qc = (__ldg(row + q / kPerByte) >> ((q % kPerByte) * BITS)) & kMask;
      // row 0, and the seed of the deletion cascade (class 1, pos BIG_NEG)
      dc = Cq(0);
      ds = Sq(0);
      dor = Oq(0);
      run = {dc + ins_cost_inc, kSeedTie, ds + ins_score_inc,
             dor + origin_increment};
      Cq(0) = run.c;
      Sq(0) = run.s;
      Oq(0) = run.o;
#pragma unroll
      for (int w = 0; w < nw; ++w) Mw(w) = 0;
      if (run.c <= k) {
        if constexpr (REG) own = 1;
        else Mw(0) = 1;
      }
    } else {
      qc = qc_in;
      run = in;
      dc = up_c;
      ds = up_s;
      dor = up_o;
      up_c = in.c;
      up_s = in.s;
      up_o = in.o;
    }
    // BITS=8: the query code itself; otherwise its class bit
    const int32_t qkey = BITS == 8 ? qc : 1 << qc;

#pragma unroll
    for (int q = 0; q < r; ++q) {
      const int i = row0 + q;
      if ((q == 0 && lane == 0) || i > m) continue;
      const int32_t pc = Cq(q), ps = Sq(q), po = Oq(q);
      int32_t rm;
      if constexpr (REG) rm = RM[q];
      else rm = __ldg(tables + i - 1);
      const bool eq = BITS == 8 ? rm == qkey : (rm & qkey) != 0;
      run = dp_cell(run, dc, ds, dor, pc, ps, po, eq, i, ins_cost, del_cost);
      Cq(q) = run.c;
      Sq(q) = run.s;
      Oq(q) = run.o;
      if (run.c <= k) {
        if constexpr (REG) own |= 1u << q;
        else Mw(i >> 6) |= 1ull << (i & 63);
      }
      dc = pc;
      ds = ps;
      dor = po;
    }
    if constexpr (REG) {
      const int w0 = row0 >> 6, sh = row0 & 63;
      const unsigned long long lo = (unsigned long long)own << sh;
      const unsigned long long hi =
          sh ? (unsigned long long)own >> (64 - sh) : 0ull;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        mk[w] |= (w == w0 ? lo : 0ull) | (w == w0 + 1 ? hi : 0ull);
    }
    qc_out = qc;

    if (lane == lm) {
      // Ukkonen band update: shrunk = highest row <= fill_end with cost <= k
      const int fill_end = last;
      int shrunk = -1;
#pragma unroll
      for (int w = nw - 1; w >= 0; --w) {
        const unsigned long long x = Mw(w) & rows_upto(fill_end, w);
        if (shrunk < 0 && x) shrunk = 64 * w + 63 - __clzll(x);
      }
      last = shrunk < m ? shrunk + 1 : m;
      last_filled = fill_end;

      // last-row candidate (run holds row m of the new column)
      if (stop_in_query && shrunk == m && !done) {
        const int32_t mc = run.c, ms = run.s, mo = run.o;
        const int32_t length = m + min(mo, 0);
        int32_t cur_eff = length;
        if (p.wildcard_ref) {
          const int32_t tail_n =
              __ldg(ncnt + m) - __ldg(ncnt + min(max(m - length, 0), m));
          cur_eff = length < m ? length - tail_n : p.eff_len;
        }
        const int32_t need_len = __ldg(minlen + min(mc, cost_cap));
        const bool acceptable = length >= p.min_overlap && cur_eff >= need_len;
        const int32_t best_length = m + min(best_origin, 0);
        const bool update =
            acceptable &&
            (!best_found ||
             (mo <= best_origin + half_m && ms > best_score) ||
             (length > best_length && ms > best_score));
        if (update) {
          best_found = true;
          best_cost = mc;
          best_score = ms;
          best_origin = mo;
          best_ref_stop = m;
          best_query_stop = j;
          if (mc == 0 && mo >= 0) done = true;
        }
      }
    }
  }

  // the final column, row by row, for the last lane's scan
  int32_t* stage = smem + group * 3 * L * RA;
  if constexpr (REG) {
#pragma unroll
    for (int q = 0; q < RR; ++q) {
      stage[row0 + q] = C[q];
      stage[L * RR + row0 + q] = S[q];
      stage[2 * L * RR + row0 + q] = O[q];
    }
  }
  __syncwarp();
  if (lane != lm || !valid) return;
  auto final_row = [&](int i, int a) -> int32_t {
    if constexpr (REG) return stage[a * L * RR + i];
    else return base[(3 * (i % r) + a) * kThreads + threadIdx.x - lane + i / r];
  };

  // The stale origin (see the note at the top): row last_filled of the
  // final column when last_filled >= 1; otherwise it is never read.
  const int32_t stale = last_filled >= 1 ? final_row(last_filled, 2) : 0;

  // final-column scan, bottom-up over rows m..first_i (:405-447)
  if (max_n == n) {
    const int first_i = stop_in_ref ? 0 : m;
    for (int i = m; i >= first_i; --i) {
      const int32_t cand_cost = final_row(i, 0);
      const int32_t cand_score = final_row(i, 1);
      const int32_t cand_origin = final_row(i, 2);
      const int32_t length = i + min(cand_origin, 0);
      int32_t cur_eff = length;
      if (p.wildcard_ref) {
        const int32_t ref_start = -min(cand_origin, 0);
        const int32_t span_n =
            __ldg(ncnt + i) - __ldg(ncnt + min(max(ref_start, 0), m));
        cur_eff = length < m ? length - span_n : p.eff_len;
      }
      const int32_t need_len = __ldg(minlen + min(cand_cost, cost_cap));
      const bool acceptable = length >= p.min_overlap && cur_eff >= need_len;
      const int32_t best_length = best_ref_stop + min(best_origin, 0);
      const bool update =
          i <= last_filled && acceptable &&
          (!best_found ||
           (stale <= best_origin + half_m && cand_score > best_score) ||
           (length > best_length && cand_score > best_score));
      if (update) {
        best_found = true;
        best_cost = cand_cost;
        best_score = cand_score;
        best_origin = cand_origin;
        best_ref_stop = i;
        best_query_stop = n;
      }
    }
  }

  const uint32_t query_start = best_origin >= 0 ? best_origin : 0;
  if (p.wide) {
    const size_t B = (size_t)p.B;
    out[b] = best_found;
    out[B + b] = (int32_t)query_start;
    out[2 * B + b] = best_query_stop;
    out[3 * B + b] = best_cost;
    out[4 * B + b] = best_score;
    out[5 * B + b] = best_origin >= 0 ? 0 : -best_origin;
    out[6 * B + b] = best_ref_stop;
    return;
  }
  out[b] = (int32_t)(query_start | ((uint32_t)best_query_stop << 14) |
                     ((uint32_t)best_found << 28));
  out[(size_t)p.B + b] =
      (int32_t)((uint32_t)best_cost | ((uint32_t)(best_score + 32768) << 16));
}

template <int BITS, int L, int RR, int MODE>
cudaError_t launch(const uint8_t* enc, const int32_t* lengths,
                   const int32_t* tables, int32_t* out, int32_t* scratch,
                   const Params& p, size_t smem_bytes, cudaStream_t stream) {
  auto kernel = locate_kernel<BITS, L, RR, MODE>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return err;
  }
  constexpr int kReadsPerBlock = kThreads / L;
  const int blocks = (p.B + kReadsPerBlock - 1) / kReadsPerBlock;
  kernel<<<blocks, kThreads, smem_bytes, stream>>>(enc, lengths, tables, out,
                                                   scratch, p);
  return cudaGetLastError();
}

// The variants: registers for up to 8 rows per lane (8 lanes up to 64
// rows, 16 lanes up to 128, 32 lanes up to 256), memory beyond.
template <int BITS>
cudaError_t dispatch(int lanes, int rows, int mode, const uint8_t* enc,
                     const int32_t* lengths, const int32_t* tables,
                     int32_t* out, int32_t* scratch, const Params& p,
                     size_t sb, cudaStream_t s) {
#define ALIGN_VARIANT(L_, R_)                                                 \
  if (lanes == L_ && rows == R_)                                             \
    return launch<BITS, L_, R_, kRegisters>(enc, lengths, tables, out,       \
                                            scratch, p, sb, s);
  if (mode == kRegisters) {
    // the byte lane's adapters have m >= 16: 8 lanes of 3 rows or more
    if constexpr (BITS != 8) {
      ALIGN_VARIANT(8, 1) ALIGN_VARIANT(8, 2)
    }
    ALIGN_VARIANT(8, 3)
    ALIGN_VARIANT(8, 4) ALIGN_VARIANT(8, 5) ALIGN_VARIANT(8, 6)
    ALIGN_VARIANT(8, 7) ALIGN_VARIANT(8, 8)
    ALIGN_VARIANT(16, 5) ALIGN_VARIANT(16, 6) ALIGN_VARIANT(16, 7)
    ALIGN_VARIANT(16, 8)
    ALIGN_VARIANT(32, 5) ALIGN_VARIANT(32, 6) ALIGN_VARIANT(32, 7)
    ALIGN_VARIANT(32, 8)
    return cudaErrorInvalidValue;
  }
#undef ALIGN_VARIANT
  if (lanes != 32) return cudaErrorInvalidValue;
  if (mode == kShared)
    return launch<BITS, 32, 0, kShared>(enc, lengths, tables, out, scratch, p,
                                        sb, s);
  if (mode == kScratch && scratch)
    return launch<BITS, 32, 0, kScratch>(enc, lengths, tables, out, scratch,
                                         p, sb, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Threads per block; the wrapper sizes shared memory and scratch with it.
int align_locate_threads() { return kThreads; }

// Launches the aligner on `stream`. bits: 2, 4 or 8 (the byte lane; the
// table's first m words are then reference codes, not class masks; m >=
// 16, so no 8 x 1 or 8 x 2 variant). lanes, rows, mode: the
// variant (ops/align_cuda.py:kernel_layout): lanes per read, rows per
// lane, and where a lane keeps its rows (0 registers, 1 shared memory,
// 2 device scratch of blocks * threads * (3 * rows + 2 * mask words)
// words). wide: out is (7, B) unpacked rows instead of (2, B) packed
// words. smem_bytes covers the final-column staging (registers) or the
// rows and masks (shared memory). Returns the CUDA error code of the
// launch (0 on success).
int align_locate_launch(int bits, int lanes, int rows, int mode,
                        const uint8_t* enc, const int32_t* lengths,
                        const int32_t* tables, int32_t* out, int32_t* scratch,
                        int B, int Wp, int m, int k, int flags, int indel_cost,
                        int min_overlap, int eff_len, int wildcard_ref,
                        int n_minlen, int wide, long long smem_bytes,
                        void* stream) {
  const Params p = {B,          Wp,          m,       k,
                    flags,      indel_cost,  min_overlap, eff_len,
                    wildcard_ref, n_minlen,  rows,    wide};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sb = (size_t)smem_bytes;
  if (rows < 1 || lanes * rows < m + 1) return (int)cudaErrorInvalidValue;
  if (bits == 2)
    return dispatch<2>(lanes, rows, mode, enc, lengths, tables, out, scratch,
                       p, sb, s);
  if (bits == 4)
    return dispatch<4>(lanes, rows, mode, enc, lengths, tables, out, scratch,
                       p, sb, s);
  if (bits == 8)
    return dispatch<8>(lanes, rows, mode, enc, lengths, tables, out, scratch,
                       p, sb, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
