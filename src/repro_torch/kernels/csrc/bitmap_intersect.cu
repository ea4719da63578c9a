// Hopper (sm_90a) kernels for the CEMR extension hot loop:
//
//     R[t, :] = AND_j  table_j[row_j(t), :]       (k gathered bitmap rows)
//     pop[t]  = popcount(R[t, :])                 (int32)
//
// bitmap_intersect_kernel replaces the TPU kernel
//   src/repro/kernels/bitmap_intersect.py : bitmap_intersect_pallas
// with row_j(t) = idxs[t, j].
//
// fused_expand_intersect_kernel replaces
//   src/repro/kernels/bitmap_intersect.py : fused_expand_intersect_pallas
// with row_j(t) = idx[rows[t], slot_j] for slot_j < K0 and bitpos[t] for
// slot_j == K0, so the child tile's index columns are never materialized.
// No row is masked: (R, pop) stays a pure function of the keys, which is
// what keeps the scheduler's CER cache entries sound.
//
// Bound on this card: memory. Each output row reads k gathered rows of W
// words and writes W words plus one popcount, T*k*W*4 bytes read and
// T*W*4 + T*4 bytes written, against 3.35 TB/s of HBM; the k-1 ANDs and W
// popcounts per row are far below the integer rate.
//
// Design: one warp per output row, a few rows per block. The lanes stride
// over the W words, so the gathered row reads are coalesced; each lane ANDs
// its words across the k tables, stores them, and sums __popc, and the warp
// reduces the popcount with __shfl_down_sync. One warp owns a row, so there
// is no carry between blocks and no atomic: this takes the place of the TPU
// grid's sequential word-block axis and its popcount accumulator. Row
// indices are taken as a jnp gather takes them (negative from the end, then
// clamped into the table), so a kernel never reads past a table. Staging
// rows in shared memory, 16-byte vector loads and cp.async/TMA are later
// work.
//
// The k table base pointers, their row counts and (fused) their slots reach
// the kernel as one small device array `meta` of int64:
//   meta[0:k] = table base addresses, meta[k:2k] = row counts,
//   meta[2k:3k] = slots (fused kernel only).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see repro_torch/kernels/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxTables = 32;

// A row index as a jnp gather takes it: negative counts from the end, then
// clamped into [0, n-1].
__device__ __forceinline__ int clamp_row(long long r, long long n) {
  if (r < 0) r += n;
  return (int)(r < 0 ? 0 : (r >= n ? n - 1 : r));
}

// AND the k rows whose start addresses sit in `rowp`, store R[t], and write
// pop[t]. Called by a whole warp.
__device__ __forceinline__ void and_popcount_row(
    const uint32_t* const* rowp, int k, int n_words, int lane,
    uint32_t* __restrict__ r_out, int32_t* __restrict__ pop_out) {
  int count = 0;
  for (int w = lane; w < n_words; w += 32) {
    uint32_t acc = __ldg(rowp[0] + w);
    for (int j = 1; j < k; ++j) acc &= __ldg(rowp[j] + w);
    r_out[w] = acc;
    count += __popc(acc);
  }
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0) *pop_out = count;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bitmap_intersect_kernel(const long long* __restrict__ meta, int k,
                        const int32_t* __restrict__ idxs, int n_out,
                        int n_words, uint32_t* __restrict__ r,
                        int32_t* __restrict__ pop) {
  __shared__ const uint32_t* rowp[kWarpsPerBlock][kMaxTables];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarpsPerBlock + warp;
  if (t >= n_out) return;                  // the whole warp leaves together
  if (lane < k) {
    const uint32_t* base = reinterpret_cast<const uint32_t*>(meta[lane]);
    const int row = clamp_row(idxs[(long long)t * k + lane], meta[k + lane]);
    rowp[warp][lane] = base + (long long)row * n_words;
  }
  __syncwarp();
  and_popcount_row(rowp[warp], k, n_words, lane,
                   r + (long long)t * n_words, pop + t);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_expand_intersect_kernel(const long long* __restrict__ meta, int k,
                              const int32_t* __restrict__ idx, int n_in,
                              int k0, const int32_t* __restrict__ rows,
                              const int32_t* __restrict__ bitpos, int n_out,
                              int n_words, uint32_t* __restrict__ r,
                              int32_t* __restrict__ pop) {
  __shared__ const uint32_t* rowp[kWarpsPerBlock][kMaxTables];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarpsPerBlock + warp;
  if (t >= n_out) return;
  if (lane < k) {
    const uint32_t* base = reinterpret_cast<const uint32_t*>(meta[lane]);
    const int slot = (int)meta[2 * k + lane];
    long long key;
    if (slot < k0) {
      const int src = clamp_row(rows[t], n_in);
      key = idx[(long long)src * k0 + slot];
    } else {
      key = bitpos[t];
    }
    const int row = clamp_row(key, meta[k + lane]);
    rowp[warp][lane] = base + (long long)row * n_words;
  }
  __syncwarp();
  and_popcount_row(rowp[warp], k, n_words, lane,
                   r + (long long)t * n_words, pop + t);
}

inline unsigned n_blocks(int n_out) {
  return (unsigned)((n_out + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

int cemr_max_tables() { return kMaxTables; }

const char* cemr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int cemr_bitmap_intersect(const long long* meta, int k, const int32_t* idxs,
                          int n_out, int n_words, int32_t* r, int32_t* pop,
                          void* stream) {
  bitmap_intersect_kernel<<<n_blocks(n_out), kWarpsPerBlock * 32, 0,
                            (cudaStream_t)stream>>>(
      meta, k, idxs, n_out, n_words, reinterpret_cast<uint32_t*>(r), pop);
  return (int)cudaGetLastError();
}

int cemr_fused_expand_intersect(const long long* meta, int k,
                                const int32_t* idx, int n_in, int k0,
                                const int32_t* rows, const int32_t* bitpos,
                                int n_out, int n_words, int32_t* r,
                                int32_t* pop, void* stream) {
  fused_expand_intersect_kernel<<<n_blocks(n_out), kWarpsPerBlock * 32, 0,
                                  (cudaStream_t)stream>>>(
      meta, k, idx, n_in, k0, rows, bitpos, n_out, n_words,
      reinterpret_cast<uint32_t*>(r), pop);
  return (int)cudaGetLastError();
}

}  // extern "C"
