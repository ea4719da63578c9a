// Hopper (sm_90a) kernels for the CEMR extension hot loop:
//
//     R[t, :] = AND_j  table_j[key_j(t), :]  with same-label bits cleared
//     pop[t]  = popcount(R[t, :])            (int32, after the clears)
//
// intersect_kernel (one warp per output row) serves three entry points:
//   * cemr_intersect with keys idx[t, slot_j] read straight from a tile's
//     index columns, and the bit idx[t, c] cleared for each same-label
//     column c: the whole pair branch of the engine's extension compute.
//     It replaces src/repro/kernels/bitmap_intersect.py :
//     bitmap_intersect_pallas (and the column stacking and clears around
//     it); the old (tables, idxs) contract is the case slot_j = j, no
//     clears;
//   * the same with a query lane (qslot >= 0): each table is a stack of
//     nq per-query tables of rows[j] rows, and row t reads query
//     idx[t, qslot]'s table, R[t] = AND_j table_j[qid, key_j(t)] — the
//     cross-query superbatch's pair branch, where the query id is index
//     column 0 of the batched tile (so expand_select carries it into the
//     child tile with the other parent columns);
//   * cemr_intersect with a given selection (rows, bitpos): key slot
//     s < K0 reads idx[rows[t], s] and slot K0 reads bitpos[t]; the old
//     fused_expand_intersect contract.
// expand_select_kernel selects set-bit ranks [start, start + T_out) of the
// frontier bitmap in row-major order (the port of bitops.expand_select),
// writes the child tile's index columns idx[rows[t], :] ++ bitpos[t],
// and, given tables, goes on in the same launch to the intersect above
// with the child's keys: it replaces src/repro/kernels/bitmap_intersect.py
// : fused_expand_intersect_pallas, which consumes that selection, and the
// selection itself.
// No row is masked: (R, pop) stays a pure function of the keys, which is
// what keeps the scheduler's CER cache entries sound.
//
// Bound on this card: memory, and far under the launch. Each output row
// reads k gathered rows of W words and writes W words plus its popcount;
// the selection reads the frontier (T_in x W_in words) once more. For
// expand_intersect at the dblp size-8 plan's widest extend (k = 1, W = 82,
// T = 256) that is about 0.19 MB, 0.06 us at 3.35 TB/s; at eu2005's
// widest (k = 2, W = W_in = 246, T = 256) about 0.76 MB, 0.23 us. Every
// table set of the paper's datasets fits in the 50 MB L2. A launch costs about 2 us, so
// the design is about what one launch absorbs, not about a faster body:
// the selection (13 + 9 torch launches of popcount, cumsums, searchsorted,
// gathers and nth_set_bit), the key-column stacking, the parent-index
// gather and concat, and the same-label clears all move into a launch.
//
// Design. One warp per output row: the lanes stride over the W words, so
// gathered row reads are coalesced; each lane ANDs its words across the k
// tables, clears the same-label bits, stores and sums __popc, and the warp
// reduces the popcount. The word-block width (`words_per_block`, 32, 64
// or 128: the words one warp reads of a row in one pass, 32 lanes times the
// 1, 2 or 4 words each lane keeps in flight of each table) is a template
// parameter of intersect_row and of both kernels, one instantiation per
// width; the C entries take the width and refuse one with no
// instantiation. 128 is the default of every entry point. The width
// changes how a row is read, never what is computed: every width gives
// the same bits. It is the counterpart of the TPU kernels' word block
// (src/repro/kernels/bitmap_intersect.py, `words_per_block`, autotuned
// over 8, 16 and 32 words), whose values are a TPU's tiling and do not
// carry over.
// The selection runs in up to 8 CTAs of 32 warps that never wait on each
// other:
//   1. each CTA counts the set bits of every frontier row (a warp keeps 8
//      rows' loads in flight) into shared memory and scans them there;
//   2. each warp takes an output row: the row from a binary search of the
//      scan, the word from a warp prefix over the row's word popcounts,
//      the bit from a ballot over the word's 32 bits; then the child index
//      columns and, with tables, the intersect above.
// Why no cluster: splitting the rows over a cluster of 8 CTAs and trading
// slice totals through distributed shared memory needs a cluster barrier
// and a scan in global memory, which at dblp's frontiers (256 rows of at
// most 82 words) cost more than counting every row in every CTA; at
// eu2005's 246 words the cluster was slightly faster.
// Any T_in and T_out: warps loop over rows; a scan too tall for shared
// memory lives in a global scratch region per CTA. The tables'
// addresses, row counts, key slots and clear slots reach each kernel by
// value in one parameter struct (no device array, no dependent load).
// Row indices are taken as a jnp gather takes them (negative from the
// end, then clamped into the table; a query id and a key each on its own
// axis), so a kernel never reads past a table;
// a negative clear value, or one past the row's words, clears nothing.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see repro_torch/kernels/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxTables = 32;
constexpr int kMaxClears = 32;
constexpr int kWarpsPerBlock = 8;        // intersect_kernel
// words one warp reads of a row in one pass, one instantiation each:
// 32 lanes x kWordsInFlight = 1, 2, 4 words a lane loads at once
constexpr int kWidths[] = {32, 64, 128};
constexpr int kNumWidths = sizeof(kWidths) / sizeof(kWidths[0]);
constexpr int kErrWidth = -1;            // no instantiation for the width
constexpr int kSelectCtas = 8;           // expand_select_kernel: at most
constexpr int kSelectWarps = 32;         // 1024 threads a CTA
constexpr int kRowsInFlight = 8;         // rows a warp counts at once
constexpr int kSmemCumRows = 8191;       // cum in smem up to 32 KB
constexpr unsigned kFull = 0xffffffffu;

// Passed by value (kernel parameter space). The host side fills it in C
// from the wrapper's ctypes struct of the same layout.
struct TableSet {
  const uint32_t* base[kMaxTables];      // table j's first word
  int rows[kMaxTables];                  // table j's row count
  int slot[kMaxTables];                  // index column of table j's key
  int clear[kMaxClears];                 // index columns whose bit is cleared
  int k;                                 // tables (0: selection only)
  int n_clear;
  int qslot;                             // index column of the query id,
                                         // -1: no query lane
  int nq;                                // queries stacked in each table
};

// Per-warp scratch: the k gathered row addresses and the clear positions.
struct WarpRows {
  const uint32_t* rowp[kMaxTables];
  int clear[kMaxClears];
};

// A row index as a jnp gather takes it: negative counts from the end, then
// clamped into [0, n-1].
__device__ __forceinline__ int clamp_row(long long r, long long n) {
  if (r < 0) r += n;
  return (int)(r < 0 ? 0 : (r >= n ? n - 1 : r));
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return __shfl_sync(kFull, v, 0);
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

// The output row's intersect, by a whole warp. value(s) is the row's index
// column s (a key or a clear position). Each lane keeps kWordsInFlight
// words of each table in flight; a pass covers 32 * kWordsInFlight words,
// and words past n_words are neither loaded nor stored.
template <int kWordsInFlight, class Value>
__device__ __forceinline__ void intersect_row(
    const TableSet& ts, Value value, int n_words, int lane, WarpRows& ws,
    uint32_t* __restrict__ r_out, int32_t* __restrict__ pop_out) {
  if (lane < ts.k) {
    long long row = clamp_row(value(ts.slot[lane]), ts.rows[lane]);
    if (ts.qslot >= 0)                   // the query's table of the stack
      row += (long long)clamp_row(value(ts.qslot), ts.nq) * ts.rows[lane];
    ws.rowp[lane] = ts.base[lane] + row * n_words;
  }
  if (lane < ts.n_clear) ws.clear[lane] = value(ts.clear[lane]);
  __syncwarp();
  int count = 0;
  for (int w0 = lane; w0 < n_words; w0 += 32 * kWordsInFlight) {
    uint32_t acc[kWordsInFlight];
#pragma unroll
    for (int u = 0; u < kWordsInFlight; ++u) {
      const int w = w0 + 32 * u;
      acc[u] = w < n_words ? __ldg(ws.rowp[0] + w) : 0u;
    }
    for (int j = 1; j < ts.k; ++j) {
#pragma unroll
      for (int u = 0; u < kWordsInFlight; ++u) {
        const int w = w0 + 32 * u;
        if (w < n_words) acc[u] &= __ldg(ws.rowp[j] + w);
      }
    }
#pragma unroll
    for (int u = 0; u < kWordsInFlight; ++u) {
      const int w = w0 + 32 * u;
      if (w >= n_words) break;
      for (int c = 0; c < ts.n_clear; ++c) {
        const int v = ws.clear[c];
        if (v >= 0 && (v >> 5) == w) acc[u] &= ~(1u << (v & 31));
      }
      r_out[w] = acc[u];
      count += __popc(acc[u]);
    }
  }
  count = warp_sum(count);
  if (lane == 0) *pop_out = count;
  __syncwarp();                          // ws is reused by the next row
}

// Keys of output row t: slot s < k0 reads idx[p, s] with p = rows[t]
// (clamped into the parent) or t itself when rows is null; slot k0 reads
// bitpos[t].
template <int kWordsInFlight>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
intersect_kernel(const TableSet ts, const int32_t* __restrict__ idx,
                 int n_in, int k0, const int32_t* __restrict__ rows,
                 const int32_t* __restrict__ bitpos, int n_out, int n_words,
                 uint32_t* __restrict__ r, int32_t* __restrict__ pop) {
  __shared__ WarpRows scratch[kWarpsPerBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarpsPerBlock + warp;
  if (t >= n_out) return;                // the whole warp leaves together
  const long long p = rows ? clamp_row(rows[t], n_in) : t;
  auto value = [&](int s) -> int {
    return s < k0 ? idx[p * k0 + s] : bitpos[t];
  };
  intersect_row<kWordsInFlight>(ts, value, n_words, lane, scratch[warp],
                                r + (long long)t * n_words, pop + t);
}

struct SelectArgs {
  const uint32_t* bm;                    // (n_in, w_in) frontier bitmap
  int n_in, w_in;
  long long start;                       // first selected rank
  int n_out;
  const int32_t* idx;                    // (n_in, k0) parent index columns
  int k0;
  int32_t* scratch;                      // null, or (kSelectCtas, n_in + 1)
                                         // when cum does not fit in smem
  int32_t* rows;                         // (n_out) outputs ...
  int32_t* bitpos;
  uint8_t* valid;
  int32_t* total;                        // () int32
  int32_t* child_idx;                    // (n_out, k0 + 1)
  int n_words;                           // tables' width (ts.k > 0)
  uint32_t* r2;                          // (n_out, n_words)
  int32_t* pop2;                         // (n_out)
};

template <int kWordsInFlight>
__global__ void __launch_bounds__(kSelectWarps * 32, 1)
expand_select_kernel(const SelectArgs a, const TableSet ts) {
  extern __shared__ int smem_cum[];
  __shared__ int warp_sums[kSelectWarps];
  __shared__ WarpRows scratch[kSelectWarps];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // cum[i] = set bits in the rows before row i, i in [0, n_in]: in shared
  // memory, or for a frontier too tall for it in this CTA's global region
  int* cum = a.scratch ? a.scratch + (long long)blockIdx.x * (a.n_in + 1)
                       : smem_cum;

  // 1. every CTA counts every row (no CTA waits on another); a warp keeps
  //    kRowsInFlight rows' loads in flight
  for (int r0 = warp; r0 < a.n_in; r0 += kSelectWarps * kRowsInFlight) {
    const uint32_t* src[kRowsInFlight];
    int part[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      // past the end: count the last row again, and store nothing
      const int row = min(r0 + u * kSelectWarps, a.n_in - 1);
      src[u] = a.bm + (long long)row * a.w_in;
      part[u] = 0;
    }
    for (int w = lane; w < a.w_in; w += 32) {
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
        part[u] += __popc(__ldg(src[u] + w));
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int row = r0 + u * kSelectWarps;
      const int c = warp_sum(part[u]);
      if (lane == 0 && row < a.n_in) cum[row + 1] = c;
    }
  }
  __syncthreads();
  // 2. their exclusive prefix, 1024 rows at a time
  int carry = 0;
  for (int base = 0; base < a.n_in; base += kSelectWarps * 32) {
    const int i = base + tid;
    const int x = warp_inclusive_scan(i < a.n_in ? cum[i + 1] : 0, lane);
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) warp_sums[lane] = warp_inclusive_scan(warp_sums[lane], lane);
    __syncthreads();
    if (i < a.n_in) cum[i + 1] = carry + (warp ? warp_sums[warp - 1] : 0) + x;
    carry += warp_sums[kSelectWarps - 1];
    __syncthreads();                     // before warp_sums is reused
  }
  if (tid == 0) cum[0] = 0;
  __syncthreads();
  const int total = cum[a.n_in];
  if (blockIdx.x == 0 && tid == 0) *a.total = total;

  // 3. one output row per warp
  for (int t = blockIdx.x * kSelectWarps + warp; t < a.n_out;
       t += gridDim.x * kSelectWarps) {
    const long long g = a.start + t;
    // the row: searchsorted(cum, g, right) - 1, clamped to the last row
    int lo = 0, hi = a.n_in + 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid] <= g) lo = mid + 1; else hi = mid;
    }
    const int row = min(lo - 1, a.n_in - 1);
    const long long q = g - cum[row];    // rank of g within its row
    const long long p = row;
    if (lane < a.k0)                     // the parent columns, for later
      asm volatile("prefetch.L1 [%0];" :: "l"(a.idx + p * a.k0 + lane));
    // the word: how many words have an inclusive prefix <= q
    const uint32_t* src = a.bm + p * a.w_in;
    int n_le = 0, below = 0, run = 0;
    for (int base = 0; base < a.w_in; base += 32) {
      const int w = base + lane;
      const int pc = w < a.w_in ? __popc(__ldg(src + w)) : 0;
      const int incl = run + warp_inclusive_scan(pc, lane);
      const unsigned le = __ballot_sync(kFull, w < a.w_in && incl <= q);
      n_le += __popc(le);
      if (le) below = __shfl_sync(kFull, incl, 31 - __clz(le));
      run = __shfl_sync(kFull, incl, 31);
      if (le != kFull) break;
    }
    int word_idx = n_le;
    if (word_idx > a.w_in - 1) {         // every prefix <= q: the last word
      word_idx = a.w_in - 1;
      below -= __popc(__ldg(src + word_idx));
    }
    const uint32_t word = __ldg(src + word_idx);
    const long long rank = q - below;
    // the rank-th set bit of the word, 0 when the word has fewer bits
    const bool hit = ((word >> lane) & 1u)
        && __popc(word & ((1u << lane) - 1u)) == rank;
    const unsigned hits = __ballot_sync(kFull, hit);
    const int bitpos = word_idx * 32 + (hits ? __ffs(hits) - 1 : 0);
    if (lane == 0) {
      a.rows[t] = row;
      a.bitpos[t] = bitpos;
      a.valid[t] = g < total;
    }
    auto value = [&](int s) -> int {
      return s < a.k0 ? a.idx[p * a.k0 + s] : bitpos;
    };
    for (int s = lane; s <= a.k0; s += 32)
      a.child_idx[(long long)t * (a.k0 + 1) + s] = value(s);
    if (ts.k > 0)
      intersect_row<kWordsInFlight>(ts, value, a.n_words, lane,
                                    scratch[warp],
                                    a.r2 + (long long)t * a.n_words,
                                    a.pop2 + t);
  }
}

// Calls launch(std::integral_constant<int, words a lane keeps in flight>)
// for the instantiation of `words_per_block`; kErrWidth for a width that
// has none (no rounding to one that has).
template <class Launch>
int with_width(int words_per_block, Launch launch) {
  static_assert(kNumWidths == 3, "a case for each width");
  switch (words_per_block) {
    case kWidths[0]:
      return launch(std::integral_constant<int, kWidths[0] / 32>());
    case kWidths[1]:
      return launch(std::integral_constant<int, kWidths[1] / 32>());
    case kWidths[2]:
      return launch(std::integral_constant<int, kWidths[2] / 32>());
  }
  return kErrWidth;
}

}  // namespace

extern "C" {

int cemr_max_tables() { return kMaxTables; }
int cemr_max_clears() { return kMaxClears; }
int cemr_table_set_bytes() { return (int)sizeof(TableSet); }
int cemr_select_ctas() { return kSelectCtas; }
int cemr_smem_cum_rows() { return kSmemCumRows; }
int cemr_num_widths() { return kNumWidths; }
int cemr_width(int i) { return i >= 0 && i < kNumWidths ? kWidths[i] : 0; }
int cemr_error_width() { return kErrWidth; }

const char* cemr_error_string(int code) {
  if (code == kErrWidth) return "words_per_block has no instantiation";
  return cudaGetErrorString((cudaError_t)code);
}

// Each returns cudaGetLastError() after its launch (0 = cudaSuccess), or
// kErrWidth, launching nothing, for a words_per_block with no
// instantiation.
// `table_set` points to a host TableSet (a type of this file only, so the
// C interface takes it untyped), which the launch copies by value.
int cemr_intersect(const void* table_set, const int32_t* idx, int n_in, int k0,
                   const int32_t* rows, const int32_t* bitpos, int n_out,
                   int n_words, int32_t* r, int32_t* pop, int words_per_block,
                   void* stream) {
  const unsigned blocks = (unsigned)((n_out + kWarpsPerBlock - 1)
                                     / kWarpsPerBlock);
  return with_width(words_per_block, [&](auto words) {
    intersect_kernel<decltype(words)::value>
        <<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
            *static_cast<const TableSet*>(table_set), idx, n_in, k0, rows,
            bitpos, n_out, n_words, reinterpret_cast<uint32_t*>(r), pop);
    return (int)cudaGetLastError();
  });
}

int cemr_expand_select(const void* table_set, const int32_t* bm, int n_in,
                       int w_in, long long start, int n_out,
                       const int32_t* idx, int k0, int32_t* scratch,
                       int32_t* rows, int32_t* bitpos, uint8_t* valid,
                       int32_t* total, int32_t* child_idx, int n_words,
                       int32_t* r2, int32_t* pop2, int words_per_block,
                       void* stream) {
  SelectArgs a;
  a.bm = reinterpret_cast<const uint32_t*>(bm);
  a.n_in = n_in;
  a.w_in = w_in;
  a.start = start;
  a.n_out = n_out;
  a.idx = idx;
  a.k0 = k0;
  a.scratch = n_in > kSmemCumRows ? scratch : nullptr;
  a.rows = rows;
  a.bitpos = bitpos;
  a.valid = valid;
  a.total = total;
  a.child_idx = child_idx;
  a.n_words = n_words;
  a.r2 = reinterpret_cast<uint32_t*>(r2);
  a.pop2 = pop2;
  const int ctas = max(1, min(kSelectCtas, (n_out + kSelectWarps - 1)
                                           / kSelectWarps));
  const size_t smem = a.scratch ? 0 : (size_t)(n_in + 1) * sizeof(int);
  return with_width(words_per_block, [&](auto words) {
    expand_select_kernel<decltype(words)::value>
        <<<ctas, kSelectWarps * 32, smem, (cudaStream_t)stream>>>(
            a, *static_cast<const TableSet*>(table_set));
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
