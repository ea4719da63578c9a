// Hopper (sm_90a) kernels for single-token GQA decode attention:
//
//     out[b, h, :] = softmax_{p < len_b}( q[b, h, :] . k[b, p, h / G, :]
//                                         * scale ) @ v[b, :, h / G, :]
//
// with G = H / Hkv query heads per KV head, len_b = lengths[b] (S when no
// lengths are given), fp32 accumulation throughout and the output cast to
// q's dtype. They replace the TPU kernel
//   src/repro/kernels/flash_decode.py:100 : flash_decode_pallas (body
//   _kernel), which walks the cache in S-blocks along a sequential grid
//   axis and carries the online-softmax state (m, l, acc) in scratch.
//
// Bound on this card: memory. The function must read sum_b len_b rows of K
// and of V for each KV head, sum_b len_b * Hkv * D * 2 * sizeof(cache)
// bytes, at 3.35 TB/s (about 0.16 ms for one qwen2-1.5b layer at
// decode_32k); its ~4 flops per cache element sit far below any compute
// rate. The design serves that bound:
//
// * Split-KV grid over KV heads (flash-decoding). One CTA per (KV head,
//   chunk of positions, b), the KV heads of a chunk next to each other in
//   launch order, so the parts of one cache row span are read at about
//   the same time. A CTA computes all query heads of its KV head, up to
//   kHeads = 16 (a larger group is cut into blocks of 16, and each block
//   reads the KV head once), so a cache byte is read from HBM once, not G
//   times. The chunk length comes from the shapes alone (the wrapper's
//   `split_plan`): the host never reads `lengths`. A CTA whose chunk
//   starts at or past len_b writes an empty partial (m = -inf, l = 0) and
//   exits, so ragged rows cost what their lengths cost: the longest row is
//   many CTAs, not one.
// * Partials and a combine. With more than one chunk each CTA writes
//   (acc[D], m, l) per query head in fp32 to the wrapper's workspace
//   (B, H, n_chunks, D + 2), and `combine_kernel` merges the chunks of one
//   (b, h) with the log-sum-exp rescale and writes out in q's dtype; all
//   chunks empty gives 0/0 = NaN. The combine spreads one (b, h)'s rows
//   over the warps of a CTA, so its time follows the bytes it reads and
//   not n_chunks load latencies (see combine_kernel).
//   With one chunk the CTA writes out itself.
// * Partials of a cache block (context-parallel decode, the reference's
//   src/repro/distributed/context_parallel.py `_local_partials` per shard
//   and its pmax / psum combine). `cemr_flash_decode_partials` runs the
//   same split kernels over positions [offset, offset + S) of a longer
//   cache: k and v may be views along S (a batch stride, not S * Hkv * D,
//   so no block is copied), and each CTA clamps lengths[b] - offset to the
//   block itself, on the device. It always writes the workspace, and the
//   combine kernel, in its partials mode, merges the block's chunks into
//   one fp32 row (acc[D], m, l) per (b, h) instead of the output; a block
//   wholly past lengths[b] gives the empty row (0, -inf, 0), not NaN.
//   `cemr_flash_decode_merge` runs the combine kernel over n such rows per
//   (b, h) into the output. Only these rows, (B, H, D + 2) fp32 a block,
//   cross devices; no cache byte does.
// * HBM kept busy. K and V tiles stream through a shared-memory ring with
//   16-byte cp.async (a bf16 row of D = 128 is 16 lanes x 16 B); while one
//   tile is computed the next ones are in flight (2 x 35 KB per CTA at
//   D = 128 in bf16, two CTAs per SM). Rows at or past the chunk's end are
//   zero-filled by cp.async's source size 0, never read. Each row is
//   padded by 16 bytes in shared memory, so the 8 rows of an ldmatrix or
//   of a column read fall on different banks.
// * The tensor-core route (`split_mma_kernel`): bf16 q over a bf16 cache
//   with D a multiple of 16, the decode_32k path. Each warp owns 16
//   positions of a 64-position tile and its own online-softmax state, so a
//   tile costs one CTA barrier. Q K^T is mma.sync.m16n8k16 bf16 with fp32
//   accumulation: the (up to) 16 query heads are the A tile's rows, fed by
//   ldmatrix; bf16 products are exact in fp32, so only the order of the
//   sums differs from the plain version. The scores stay in registers
//   (a row's max and sum take two shuffles across its 4 lanes), and their
//   C fragments are P V's A fragments. P V is mma too, with P split into
//   two bf16 terms, hi = bf16(P) and lo = bf16(P - hi), so that P keeps
//   ~16 bits (error ~2^-17 of P, far below a bf16 output step) while V
//   (bf16, exact) comes in through ldmatrix.trans. The warps' (m, l, acc)
//   merge in shared memory at the end. wgmma's 64-row minimum would waste
//   over 90 % of the M = 16 tile.
// * The CUDA-core route (`split_fma_kernel`): every other case (an fp32 q
//   or cache, D not a multiple of 16) runs the same split and grouped
//   structure with fp32 FMA: scores one thread per (position, head),
//   16-byte shared-memory reads into four independent sums,
//   softmax per head by one warp in shared memory, P V with each thread
//   owning two adjacent dims of every few heads. A row that is not 16-byte
//   aligned (odd D in bf16, say) takes synchronous loads into the ring:
//   a dispatch on shape before launch.
//
// Contract: 1 <= lengths[b] <= S (of a block: lengths[b] - offset may be
// anything, clamped to [0, S]). A larger length is clamped to S; a row
// with lengths[b] <= 0 attends to nothing and gives 0/0 = NaN, as the
// plain version's softmax over an all-masked row does. q, k, v, out are
// contiguous; D <= kMaxHeadDim; H is a multiple of Hkv.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see repro_torch/kernels/build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;            // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 16;               // query heads per CTA: mma's M
constexpr int kMaxHeadDim = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);                  // round to nearest even
}

// two adjacent cache values as floats (the smem row offset is even)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// q . k over head_dim elements of two shared-memory rows, q in fp32. Four
// sums run side by side, so no FMA waits on the one before. VEC: the
// rows are 16-byte aligned and head_dim * sizeof(TKV) is a multiple of 16,
// so both come in 16 bytes at a time.
template <bool VEC>
__device__ __forceinline__ float dot_row(const float* q, const float* k,
                                         int head_dim) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  int d = 0;
  if constexpr (VEC) {
    for (; d < head_dim; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q + d);
      const float4 kv = *reinterpret_cast<const float4*>(k + d);
      a[0] = fmaf(qv.x, kv.x, a[0]);
      a[1] = fmaf(qv.y, kv.y, a[1]);
      a[2] = fmaf(qv.z, kv.z, a[2]);
      a[3] = fmaf(qv.w, kv.w, a[3]);
    }
  } else {
    for (; d + 4 <= head_dim; d += 4)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = fmaf(q[d + j], k[d + j], a[j]);
    for (; d < head_dim; ++d) a[0] = fmaf(q[d], k[d], a[0]);
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}
template <bool VEC>
__device__ __forceinline__ float dot_row(const float* q, const bf16* k,
                                         int head_dim) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  int d = 0;
  if constexpr (VEC) {
    for (; d < head_dim; d += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(k + d);
      const __nv_bfloat162* kh =
          reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(q + d + 4 * j);
        const float2 k0 = __bfloat1622float2(kh[2 * j]);
        const float2 k1 = __bfloat1622float2(kh[2 * j + 1]);
        a[0] = fmaf(qv.x, k0.x, a[0]);
        a[1] = fmaf(qv.y, k0.y, a[1]);
        a[2] = fmaf(qv.z, k1.x, a[2]);
        a[3] = fmaf(qv.w, k1.y, a[3]);
      }
    }
  } else {
    for (; d + 4 <= head_dim; d += 4)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[j] = fmaf(q[d + j], __bfloat162float(k[d + j]), a[j]);
    for (; d < head_dim; ++d)
      a[0] = fmaf(q[d], __bfloat162float(k[d]), a[0]);
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const int src_bytes = valid ? 16 : 0;        // 0: zero-fill, no read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and lane t receives (row t / 4, cols 2 (t % 4), + 1) of each
// (of its transpose with .trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, fp32) += a (16 x 16 bf16, row-major) * b (16 x 8, col-major)
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}
// (x, y) = hi + lo to ~16 bits: hi = bf16(x, y), lo = bf16(rest), packed
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - __low2float(h),
                                    y - __high2float(h)));
}

// Which query heads and positions a CTA owns.
struct Cta {
  int b, kvh, c;
  int h0;        // first query head
  int gb;        // query heads of this CTA, <= kHeads
  int start;     // first position of the chunk
  int end;       // one past its last valid position (<= start: empty)
};

__device__ __forceinline__ Cta cta_coords(const int32_t* lengths,
                                          int n_heads, int n_kv, int seq,
                                          int chunk, int offset) {
  Cta t;
  const int group = n_heads / n_kv;
  const int n_hblk = (group + kHeads - 1) / kHeads;
  t.kvh = blockIdx.x / n_hblk;
  const int hb = blockIdx.x - t.kvh * n_hblk;
  t.c = blockIdx.y;
  t.b = blockIdx.z;
  t.h0 = t.kvh * group + hb * kHeads;
  t.gb = min(kHeads, group - hb * kHeads);
  // the block's own length: positions offset.. of the row's lengths[b]
  int len = lengths ? lengths[t.b] - offset : seq;
  len = len < 0 ? 0 : (len > seq ? seq : len);
  t.start = t.c * chunk;
  t.end = min(t.start + chunk, len);
  return t;
}

// 16-byte cp.async of a tile of TP cache rows of D elements into smem rows
// of RE elements. Each copy of a thread lands at the same (row, column) in
// every tile, so its offsets are worked out once.
template <typename T, int TP, int RE, int DPAD>
struct TileLoader {
  static constexpr int E = 16 / (int)sizeof(T);
  static constexpr int kItems = (TP * DPAD / E + kThreads - 1) / kThreads;
  int s_off[kItems], g_off[kItems], row[kItems];

  __device__ __forceinline__ TileLoader(int head_dim, int row_stride) {
    const int per_row = head_dim / E;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int it = threadIdx.x + j * kThreads;
      const int r = it / per_row;
      const int e = (it - r * per_row) * E;
      row[j] = it < TP * per_row ? r : TP;
      s_off[j] = r * RE + e;
      g_off[j] = r * row_stride + e;
    }
  }
  // rows p0 + r, r < TP, of kb and vb (row p at p * row_stride); rows at
  // or past `end` are zero-filled
  __device__ __forceinline__ void load(T* kd, T* vd, const T* kb,
                                       const T* vb, int p0, int end,
                                       int row_stride) const {
    const T* kt = kb + (long long)p0 * row_stride;
    const T* vt = vb + (long long)p0 * row_stride;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (row[j] >= TP) continue;
      const bool valid = p0 + row[j] < end;
      cp_async16(kd + s_off[j], valid ? kt + g_off[j] : kt, valid);
      cp_async16(vd + s_off[j], valid ? vt + g_off[j] : vt, valid);
    }
  }
};

// ---------------------------------------------------------------------
// Tensor-core route: bf16 q and cache, D % 16 == 0, 16-byte aligned rows.

template <int DPAD>
struct MmaLayout {
  static constexpr int kTile = 64;                 // 16 positions a warp
  static constexpr int kStages = 3;
  static constexpr int kRowElems = DPAD + 8;       // + 16 bytes
  static constexpr int kStageElems = kTile * kRowElems;
  static constexpr int kRingBytes = 2 * kStages * kStageElems * 2;
  static constexpr int kSmemBytes = kRingBytes + kHeads * kRowElems * 2;
  // the end-of-loop merge reuses the ring: m, l, acc per (warp, head)
  static_assert(kWarps * kHeads * (2 + DPAD) * 4 <= kRingBytes,
                "merge buffers must fit in the ring");
};

template <int DPAD>
__global__ void __launch_bounds__(kThreads)
split_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v,
                 const int32_t* __restrict__ lengths, bf16* __restrict__ out,
                 float* __restrict__ ws, int n_heads, int n_kv, int seq,
                 int head_dim, int chunk, int n_chunks, float scale,
                 long long batch_stride, int offset) {
  using L = MmaLayout<DPAD>;
  constexpr int TP = L::kTile;
  constexpr int RE = L::kRowElems;
  constexpr int NS = L::kStages;
  constexpr int kNT = DPAD / 8;                    // 8-dim output tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + NS * L::kStageElems;
  bf16* qs = vs + NS * L::kStageElems;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Cta t = cta_coords(lengths, n_heads, n_kv, seq, chunk,
                                offset);
  const int n_tiles = t.start < t.end ? (t.end - t.start + TP - 1) / TP : 0;

  // Q rows of this CTA's heads; rows >= gb and dims >= D are zero
  for (int i = tid; i < kHeads * DPAD; i += kThreads) {
    const int g = i / DPAD, d = i % DPAD;
    qs[g * RE + d] =
        (g < t.gb && d < head_dim)
            ? q[((long long)t.b * n_heads + t.h0 + g) * head_dim + d]
            : __float2bfloat16(0.f);
  }

  // row p of head kvh of batch b starts at b * batch_stride + (p * Hkv +
  // kvh) * D (batch_stride = S * Hkv * D unless the cache is a view)
  const int row_stride = n_kv * head_dim;
  const bf16* kbase = k + t.b * batch_stride + t.kvh * head_dim;
  const bf16* vbase = v + t.b * batch_stride + t.kvh * head_dim;
  const TileLoader<bf16, TP, RE, DPAD> loader(head_dim, row_stride);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_tiles)
      loader.load(ks + i * L::kStageElems, vs + i * L::kStageElems, kbase,
                  vbase, t.start + i * TP, t.end, row_stride);
    cp_async_commit();
  }

  // lane = 4 gid + tig holds C rows gid and gid + 8 (query heads),
  // columns 2 tig and 2 tig + 1 of each 8-wide tile
  const int gid = lane >> 2, tig = lane & 3;
  // ldmatrix row addresses: lane 8 m + r gives row r of matrix m
  const int lr = lane & 7, lm = lane >> 3;
  const int q_off = (lr + (lm & 1) * 8) * RE + (lm >> 1) * 8;
  const int k_off = (warp * 16 + lr + (lm >> 1) * 8) * RE + (lm & 1) * 8;
  const int v_off = (warp * 16 + lr + (lm & 1) * 8) * RE + (lm >> 1) * 8;

  float m_run[2] = {-INFINITY, -INFINITY};  // rows gid, gid + 8
  float l_run[2] = {0.f, 0.f};              // this lane's share of l
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<NS - 2>();            // this thread's copies of tile i
    __syncthreads();                    // everyone's; tile i - 1 is done
    if (i + NS - 1 < n_tiles) {
      const int st = (i + NS - 1) % NS;
      loader.load(ks + st * L::kStageElems, vs + st * L::kStageElems, kbase,
                  vbase, t.start + (i + NS - 1) * TP, t.end, row_stride);
    }
    cp_async_commit();
    const int p0 = t.start + i * TP + warp * 16;   // this warp's positions
    if (p0 >= t.end) continue;                     // warp-uniform
    const bf16* kt = ks + (i % NS) * L::kStageElems;
    const bf16* vt = vs + (i % NS) * L::kStageElems;

    // s (16 heads x 16 positions) = Q K^T over D in steps of 16
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kk = 0; kk < head_dim; kk += 16) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, qs + q_off + kk);
      ldmatrix_x4(b, kt + k_off + kk);
      mma_bf16_16816(s[0], a, b[0], b[1]);
      mma_bf16_16816(s[1], a, b[2], b[3]);
    }

    // online softmax; positions at or past the end get -inf
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = p0 + n * 8 + 2 * tig + (e & 1) < t.end;
        s[n][e] = valid ? s[n][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], base[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      base[r] = m_new == -INFINITY ? 0.f : m_new;  // no position yet
      alpha[r] = expf(m_run[r] - base[r]);         // m_run = -inf gives 0
      m_run[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - base[e >> 1]);     // masked: 0
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V: the score fragments are the A fragments (k = position)
    uint32_t ph[4], pl[4];
    split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
    split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
    split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
    split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int n = 0; n < kNT; n += 2) {
      if (n * 8 >= head_dim) break;
      uint32_t b[4];
      ldmatrix_x4_trans(b, vt + v_off + n * 8);
      mma_bf16_16816(acc[n], ph, b[0], b[1]);
      mma_bf16_16816(acc[n], pl, b[0], b[1]);
      mma_bf16_16816(acc[n + 1], ph, b[2], b[3]);
      mma_bf16_16816(acc[n + 1], pl, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free for the merge

  // merge the warps: m, l, acc per (warp, head) in shared memory
  float* m_w = reinterpret_cast<float*>(smem);      // [kWarps][kHeads]
  float* l_w = m_w + kWarps * kHeads;
  float* a_w = l_w + kWarps * kHeads;               // [kWarps][kHeads][DPAD]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if (tig == 0) {
      m_w[warp * kHeads + gid + 8 * r] = m_run[r];
      l_w[warp * kHeads + gid + 8 * r] = l_run[r];
    }
  }
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    if (n * 8 >= head_dim) break;
    float* row0 = a_w + (warp * kHeads + gid) * DPAD + n * 8 + 2 * tig;
    float* row8 = row0 + 8 * DPAD;
    row0[0] = acc[n][0];
    row0[1] = acc[n][1];
    row8[0] = acc[n][2];
    row8[1] = acc[n][3];
  }
  __syncthreads();
  const bool empty = n_tiles == 0;
  const int wrow = head_dim + 2;
  for (int i = tid; i < t.gb * head_dim; i += kThreads) {
    const int g = i / head_dim, d = i - g * head_dim;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m_all = fmaxf(m_all, m_w[w * kHeads + g]);
    float l_all = 0.f, a_all = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = m_w[w * kHeads + g];
      if (mw == -INFINITY) continue;               // saw no position
      const float c = expf(mw - m_all);
      l_all += c * l_w[w * kHeads + g];
      a_all += c * a_w[(w * kHeads + g) * DPAD + d];
    }
    const long long bh = (long long)t.b * n_heads + t.h0 + g;
    if (!ws) {                                     // one chunk, no partials
      out[bh * head_dim + d] = __float2bfloat16(a_all / l_all);
    } else {
      float* wp = ws + (bh * n_chunks + t.c) * wrow;
      if (!empty) wp[d] = a_all;                   // an empty acc is unread
      if (d == 0) {
        wp[head_dim] = m_all;
        wp[head_dim + 1] = l_all;
      }
    }
  }
}

// ---------------------------------------------------------------------
// CUDA-core route: every other case, fp32 FMA.

// DPAD is D rounded up to a power of two in [32, 256]; a ring stage holds
// kTile rows of K and of V (16 to 32 rows, about 16 KB each): the more
// rows a tile, the fewer barriers and softmax rounds a position.
template <typename TKV, int DPAD>
struct FmaLayout {
  static constexpr int kStages = 3;
  static constexpr int kRowBytes = DPAD * (int)sizeof(TKV);
  static constexpr int kTileRaw = 16384 / kRowBytes;
  static constexpr int kTile =
      kTileRaw < 16 ? 16 : (kTileRaw > 32 ? 32 : kTileRaw);
  static constexpr int kRowElems = DPAD + 16 / (int)sizeof(TKV);
  static constexpr int kStageElems = kTile * kRowElems;  // one matrix
  static constexpr int kSRow = kTile + 4;                // score row, fp32
  static constexpr int kRingBytes =
      2 * kStages * kStageElems * (int)sizeof(TKV);
  static constexpr int kScoreBytes = kHeads * kSRow * 4;
  static constexpr int kSmemBytes =
      kRingBytes + kScoreBytes + 3 * kHeads * 4 + kHeads * DPAD * 4;
  // P V: thread t owns dims 2c, 2c+1 (c = t % kPairs) of the heads
  // g0 + j * kGStride, j < kNG (g0 = t / kPairs)
  static constexpr int kPairs = DPAD / 2;
  static constexpr int kGStride = kThreads / kPairs;
  static constexpr int kNG = kHeads / kGStride;
  static_assert(kThreads % kPairs == 0, "DPAD/2 must divide the CTA");
};

// VEC: rows are 16-byte aligned and D * sizeof(TKV) is a multiple of 16,
// so tiles stream with cp.async; otherwise synchronous loads.
template <typename TQ, typename TKV, int DPAD, bool VEC>
__global__ void __launch_bounds__(kThreads)
split_fma_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v,
                 const int32_t* __restrict__ lengths, TQ* __restrict__ out,
                 float* __restrict__ ws, int n_heads, int n_kv, int seq,
                 int head_dim, int chunk, int n_chunks, float scale,
                 long long batch_stride, int offset) {
  using L = FmaLayout<TKV, DPAD>;
  constexpr int TP = L::kTile;
  constexpr int RE = L::kRowElems;
  constexpr int NS = L::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  TKV* ks = reinterpret_cast<TKV*>(smem);
  TKV* vs = ks + NS * L::kStageElems;
  float* ss = reinterpret_cast<float*>(smem + L::kRingBytes);
  float* alpha_s = ss + kHeads * L::kSRow;
  float* m_s = alpha_s + kHeads;
  float* l_s = m_s + kHeads;
  float* qs = l_s + kHeads;                          // [kHeads][DPAD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Cta t = cta_coords(lengths, n_heads, n_kv, seq, chunk,
                                offset);
  const int gb = t.gb, end = t.end;
  const int n_tiles = t.start < end ? (end - t.start + TP - 1) / TP : 0;

  for (int i = tid; i < kHeads * DPAD; i += kThreads) {
    const int g = i / DPAD, d = i % DPAD;
    qs[i] = (g < gb && d < head_dim)
                ? to_float(q[((long long)t.b * n_heads + t.h0 + g) * head_dim
                             + d])
                : 0.f;
  }

  const int row_stride = n_kv * head_dim;
  const TKV* kbase = k + t.b * batch_stride + t.kvh * head_dim;
  const TKV* vbase = v + t.b * batch_stride + t.kvh * head_dim;
  const TileLoader<TKV, TP, RE, DPAD> loader(head_dim, row_stride);
  auto load_tile = [&](int i) {
    const int p0 = t.start + i * TP;
    TKV* kd = ks + (i % NS) * L::kStageElems;
    TKV* vd = vs + (i % NS) * L::kStageElems;
    if constexpr (VEC) {
      loader.load(kd, vd, kbase, vbase, p0, end, row_stride);
    } else {
      for (int it = tid; it < TP * head_dim; it += kThreads) {
        const int r = it / head_dim, e = it - r * head_dim;
        const bool valid = p0 + r < end;
        const long long off = (long long)(p0 + r) * row_stride + e;
        kd[r * RE + e] = valid ? kbase[off] : from_float<TKV>(0.f);
        vd[r * RE + e] = valid ? vbase[off] : from_float<TKV>(0.f);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  // softmax state: warp w owns heads w + kWarps * r, r < kHeads / kWarps
  constexpr int kRowsPerWarp = kHeads / kWarps;
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  const int pair = tid % L::kPairs;
  const int g0 = tid / L::kPairs;
  // heads g0 + j * kGStride < gb carry output
  const int n_own = g0 < gb ? (gb - g0 + L::kGStride - 1) / L::kGStride : 0;
  float acc[L::kNG][2];
#pragma unroll
  for (int j = 0; j < L::kNG; ++j) acc[j][0] = acc[j][1] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<NS - 2>();            // this thread's copies of tile i
    __syncthreads();                    // everyone's; tile i - 1 is done
    if (i + NS - 1 < n_tiles) load_tile(i + NS - 1);
    cp_async_commit();
    const TKV* kt = ks + (i % NS) * L::kStageElems;
    const TKV* vt = vs + (i % NS) * L::kStageElems;
    const int p0 = t.start + i * TP;

    // scores s[g][p] = q_g . k_p * scale, -inf at or past the chunk's end
    {
      constexpr int kGStep = kThreads / TP;
      const int p = tid % TP;
      const TKV* krow = kt + p * RE;
      const bool valid = p0 + p < end;
      for (int g = tid / TP; g < gb; g += kGStep) {
        const float dot = dot_row<VEC>(qs + g * DPAD, krow, head_dim);
        ss[g * L::kSRow + p] = valid ? dot * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax over the tile: p = exp(s - m_new) back into ss
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int g = warp + kWarps * r;
      if (g >= gb) continue;                        // warp-uniform
      float* srow = ss + g * L::kSRow;
      constexpr int kPerLane = (TP + 31) / 32;
      float sv[kPerLane];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int p = lane + 32 * j;
        sv[j] = p < TP ? srow[p] : -INFINITY;
        tmax = fmaxf(tmax, sv[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      // the tile holds a position < end, so tmax is finite
      const float m_new = fmaxf(m_run[r], tmax);
      const float alpha = expf(m_run[r] - m_new);   // m = -inf gives 0
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int p = lane + 32 * j;
        const float e = expf(sv[j] - m_new);        // masked: 0
        if (p < TP) srow[p] = e;
        psum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run[r] = l_run[r] * alpha + psum;
      m_run[r] = m_new;
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();

    // acc[g][2 pair + {0, 1}] = acc * alpha_g + sum_p p[g][p] v[p][.]
    if (n_own > 0) {
      const TKV* vcol = vt + 2 * pair;
#pragma unroll
      for (int j = 0; j < L::kNG; ++j) {
        if (j < n_own) {
          const float al = alpha_s[g0 + j * L::kGStride];
          acc[j][0] *= al;
          acc[j][1] *= al;
        }
      }
#pragma unroll 2
      for (int p = 0; p < TP; p += 4) {
        float2 vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vv[u] = load2(vcol + (p + u) * RE);
#pragma unroll
        for (int j = 0; j < L::kNG; ++j) {
          if (j < n_own) {
            const float4 pw = *reinterpret_cast<const float4*>(
                ss + (g0 + j * L::kGStride) * L::kSRow + p);
            acc[j][0] += pw.x * vv[0].x + pw.y * vv[1].x + pw.z * vv[2].x
                         + pw.w * vv[3].x;
            acc[j][1] += pw.x * vv[0].y + pw.y * vv[1].y + pw.z * vv[2].y
                         + pw.w * vv[3].y;
          }
        }
      }
    }
  }
  cp_async_wait<0>();                   // no copy outlives the CTA

  // epilogue: m and l of each head to shared memory, then the partial
  // (or, with one chunk, the output) of the dims this thread owns
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int g = warp + kWarps * r;
      m_s[g] = m_run[r];
      l_s[g] = l_run[r];
    }
  }
  __syncthreads();
  const int d0 = 2 * pair;
  const int wrow = head_dim + 2;
#pragma unroll
  for (int j = 0; j < L::kNG; ++j) {
    if (j >= n_own) continue;
    const int g = g0 + j * L::kGStride;
    const long long bh = (long long)t.b * n_heads + t.h0 + g;
    if (!ws) {                                       // one chunk, no partials
      const float l = l_s[g];                        // 0 for an empty row
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (d0 + e < head_dim)
          out[bh * head_dim + d0 + e] = from_float<TQ>(acc[j][e] / l);
      continue;
    }
    float* wp = ws + (bh * n_chunks + t.c) * wrow;
    if (n_tiles > 0) {                               // an empty acc is unread
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (d0 + e < head_dim) wp[d0 + e] = acc[j][e];
    }
    if (pair == 0) {
      wp[head_dim] = m_s[g];
      wp[head_dim + 1] = l_s[g];
    }
  }
}

// ---------------------------------------------------------------------
// The combine: out[b, h, :] = sum_c exp(m_c - M) acc_c / sum_c exp(m_c -
// M) l_c over the n_chunks rows (acc[D], m, l) of one (b, h), M = max_c
// m_c; a row with m_c = -inf (no position) weighs nothing and its acc
// (which the split leaves unwritten) is never used, so a (b, h) with none
// gives 0/0 = NaN. PARTIALS: write the
// merged row (acc[D], m, l) = (sum_c exp(m_c - M) acc_c, M, sum_c exp(m_c
// - M) l_c) in fp32 to `part` (B, H, D + 2) instead; a (b, h) with no
// position gives the empty row (0, -inf, 0). The same log-sum-exp merge
// serves three callers: the chunks of one flash_decode call, the chunks
// of one cache block (cemr_flash_decode_partials) and the blocks' partial
// rows (cemr_flash_decode_merge), which is the reference's pmax / psum
// combine of context-parallel decode
// (src/repro/distributed/context_parallel.py).
//
// Bound: bytes, the rows read once (long_500k: 12 x 257 rows of 520 B,
// 1.6 MB, 0.48 us at 3.35 TB/s). A walk of the rows one after another
// would cost n_chunks dependent load latencies, so the rows of one (b, h)
// are spread and every load a warp needs is issued at once:
// * one CTA a (b, h) of `blockDim.x / 32` warps (`combine_warps`, from
//   n_chunks alone); each warp takes a contiguous share of the rows;
// * a warp takes its rows up to U at a time: lane j loads (m, l) of row j
//   while every lane loads its slice of every row's acc (float2 a lane
//   when D is even and the rows 8-byte aligned), all in one round trip.
//   Then the rows' max (shuffles), each row's weight exp(m_c - max) on its
//   own lane (one expf a row) and the weighted sum; a row with m_c = -inf
//   is selected out, never multiplied, so whatever its acc holds is not
//   used;
// * the warps' rows (acc, m, l) merge through shared memory by the same
//   rescale.
constexpr int kCombineMaxWarps = 16;
// acc floats a lane holds in flight: rows a warp loads at once, by D
constexpr int kCombineBatchFloats = 64;

// E: floats a lane reads at a time (2 when D is even and ws 8-byte
// aligned: every row and its (m, l) pair are then 8-byte aligned); lane t
// owns dims (t + 32 s) E + e, s < kSlots, e < E.
template <typename TQ, bool PARTIALS, int DPAD, int E>
__global__ void __launch_bounds__(kCombineMaxWarps * 32)
combine_kernel(const float* __restrict__ ws, TQ* __restrict__ out,
               float* __restrict__ part, int n_chunks, int head_dim) {
  constexpr int kSlots = (DPAD + 32 * E - 1) / (32 * E);
  constexpr int U = kCombineBatchFloats / (kSlots * E) < 16
                        ? kCombineBatchFloats / (kSlots * E)
                        : 16;
  static_assert(U >= 1 && U <= 32, "a batch's rows are one a lane");
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ float rows_s[kCombineMaxWarps][DPAD + 2];  // a row a warp

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const long long bh = blockIdx.x;
  const int wrow = head_dim + 2;
  const float* w = ws + bh * n_chunks * wrow;
  // this warp's rows: a contiguous share of the (b, h)'s
  const int per = (n_chunks + n_warps - 1) / n_warps;
  const int c_begin = min(n_chunks, warp * per);
  const int c_end = min(n_chunks, c_begin + per);

  float m_run = -INFINITY, l_run = 0.f;
  float acc[kSlots][E];
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[s][e] = 0.f;

  for (int g0 = c_begin; g0 < c_end; g0 += U) {
    const int nr = min(U, c_end - g0);       // warp-uniform
    // every load of the batch at once: (m, l) of row g0 + lane, and this
    // lane's slice of each row's acc
    float mc = -INFINITY, lc = 0.f;
    if (lane < nr) {
      const float* p = w + (long long)(g0 + lane) * wrow + head_dim;
      if constexpr (E == 2) {
        const float2 ml = *reinterpret_cast<const float2*>(p);
        mc = ml.x;
        lc = ml.y;
      } else {
        mc = p[0];
        lc = p[1];
      }
    }
    float val[U][kSlots][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* r = w + (long long)(g0 + u) * wrow;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int d0 = (lane + 32 * s) * E;
        const bool ok = u < nr && d0 < head_dim;
        if constexpr (E == 2) {
          const float2 x = ok ? *reinterpret_cast<const float2*>(r + d0)
                              : make_float2(0.f, 0.f);
          val[u][s][0] = x.x;
          val[u][s][1] = x.y;
        } else {
          val[u][s][0] = ok ? r[d0] : 0.f;
        }
      }
    }
    float mg = mc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mg = fmaxf(mg, __shfl_xor_sync(kAll, mg, off));
    if (mg == -INFINITY) continue;            // warp-uniform: no position
    const float wc = mc == -INFINITY ? 0.f : expf(mc - mg);
    float lg = wc * lc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lg += __shfl_xor_sync(kAll, lg, off);
    float ag[kSlots][E];
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
#pragma unroll
      for (int e = 0; e < E; ++e) ag[s][e] = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // row u's weight; 0 for a row past nr or with no position, whose
      // acc is then selected out (it may hold anything)
      const float wu = __shfl_sync(kAll, wc, u);
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
#pragma unroll
        for (int e = 0; e < E; ++e)
          ag[s][e] = wu != 0.f ? fmaf(wu, val[u][s][e], ag[s][e]) : ag[s][e];
    }

    // fold the batch into the warp's row (m_run = -inf gives sa = 0)
    const float m_new = fmaxf(m_run, mg);
    const float sa = expf(m_run - m_new), sg = expf(mg - m_new);
    l_run = l_run * sa + lg * sg;
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[s][e] = acc[s][e] * sa + ag[s][e] * sg;
    m_run = m_new;
  }

  // the warps' rows to shared memory, then merged by every thread: the
  // CTA's (m, l), and acc for the dims d it owns
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = (lane + 32 * s) * E + e;
      if (d < head_dim) rows_s[warp][d] = acc[s][e];
    }
  if (lane == 0) {
    rows_s[warp][head_dim] = m_run;
    rows_s[warp][head_dim + 1] = l_run;
  }
  __syncthreads();
  float m = -INFINITY, l = 0.f;
  for (int i = 0; i < n_warps; ++i) m = fmaxf(m, rows_s[i][head_dim]);
  for (int i = 0; i < n_warps; ++i)
    if (rows_s[i][head_dim] != -INFINITY)
      l += expf(rows_s[i][head_dim] - m) * rows_s[i][head_dim + 1];
  for (int d = threadIdx.x; d < head_dim; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < n_warps; ++i)
      if (rows_s[i][head_dim] != -INFINITY)
        a += expf(rows_s[i][head_dim] - m) * rows_s[i][d];
    if constexpr (PARTIALS)
      part[bh * wrow + d] = a;
    else
      out[bh * head_dim + d] = from_float<TQ>(a / l);
  }
  if constexpr (PARTIALS) {
    if (threadIdx.x == 0) {
      part[bh * wrow + head_dim] = m;
      part[bh * wrow + head_dim + 1] = l;
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  void* out;
  float* ws;
  int b, h, hkv, s, d, chunk, n_chunks;
  float scale;
  long long batch_stride;  // elements from one batch row of k, v to the next
  int offset;              // the block's first position (lengths count from 0)
  cudaStream_t stream;
};

// Launch one split kernel on the grid (KV head x head block, chunk, b):
// the KV heads of a chunk innermost.
template <typename TQ, typename TKV, auto Kernel>
cudaError_t launch_split(int smem_bytes, const Args& a) {
  // shared memory above 48 KB must be asked for, once per kernel on each
  // device (the attribute belongs to the current device): bit d of
  // `asked` says it was on device d (a device past 63 asks every time)
  static std::atomic<unsigned long long> asked{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(asked.load() & bit) || !bit) {
    err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    asked.fetch_or(bit);
  }
  const int n_hblk = (a.h / a.hkv + kHeads - 1) / kHeads;
  const dim3 grid((unsigned)(a.hkv * n_hblk), (unsigned)a.n_chunks,
                  (unsigned)a.b);
  Kernel<<<grid, kThreads, smem_bytes, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.lengths, static_cast<TQ*>(a.out), a.ws,
      a.h, a.hkv, a.s, a.d, a.chunk, a.n_chunks, a.scale, a.batch_stride,
      a.offset);
  return cudaGetLastError();
}

bool aligned16(const Args& a, int elem_bytes) {
  return (a.d * elem_bytes) % 16 == 0 && (uintptr_t)a.k % 16 == 0
         && (uintptr_t)a.v % 16 == 0
         && (a.batch_stride * elem_bytes) % 16 == 0;
}

// The kernel of each route for one DPAD (D rounded up to 32, 64, 128 or
// 256): its launch and its dynamic shared memory.
template <int DPAD>
struct Mma {
  static constexpr int kSmem = MmaLayout<DPAD>::kSmemBytes;
  static cudaError_t run(const Args& a) {
    return launch_split<bf16, bf16, split_mma_kernel<DPAD>>(kSmem, a);
  }
};
template <typename TQ, typename TKV>
struct Fma {
  template <int DPAD>
  struct At {
    static constexpr int kSmem = FmaLayout<TKV, DPAD>::kSmemBytes;
    static cudaError_t run(const Args& a) {
      if (aligned16(a, (int)sizeof(TKV)))
        return launch_split<TQ, TKV, split_fma_kernel<TQ, TKV, DPAD, true>>(
            kSmem, a);
      return launch_split<TQ, TKV, split_fma_kernel<TQ, TKV, DPAD, false>>(
          kSmem, a);
    }
  };
};

// f(Route<DPAD>{}) for the DPAD that holds d
template <template <int> class Route, typename F>
auto with_dpad(int d, F f) {
  if (d <= 32) return f(Route<32>{});
  if (d <= 64) return f(Route<64>{});
  if (d <= 128) return f(Route<128>{});
  return f(Route<256>{});
}

// f(Route<DPAD>{}) for the route of these dtypes and the DPAD of d
template <typename F>
auto with_route(int d, int q_bf16, int kv_bf16, int tensor_core, F f) {
  if (tensor_core) return with_dpad<Mma>(d, f);
  if (q_bf16 && kv_bf16) return with_dpad<Fma<bf16, bf16>::At>(d, f);
  if (q_bf16) return with_dpad<Fma<bf16, float>::At>(d, f);
  if (kv_bf16) return with_dpad<Fma<float, bf16>::At>(d, f);
  return with_dpad<Fma<float, float>::At>(d, f);
}

// The combine's warps a CTA for the n rows of one (b, h): one for every
// 16 rows (a batch at D <= 128), rounded up to a power of two, at most 8:
// decode_32k's 33 rows 4, long_500k's 257 8, a merge of 4 lanes' rows 1;
// fewer or more are slower there (chip_fd_compare.py --combine-sweep).
// Built with -DCEMR_COMBINE_WARPS=w, every combine takes w warps, up to
// kCombineMaxWarps: that sweep's builds.
#ifndef CEMR_COMBINE_WARPS
#define CEMR_COMBINE_WARPS 0
#endif
static_assert(CEMR_COMBINE_WARPS >= 0 &&
                  CEMR_COMBINE_WARPS <= kCombineMaxWarps,
              "CEMR_COMBINE_WARPS: 0 (from n_chunks) or 1..16");

int combine_warps(int n) {
  if (CEMR_COMBINE_WARPS > 0) return CEMR_COMBINE_WARPS;
  int warps = 1;
  while (warps < 8 && warps * 16 < n) warps *= 2;
  return warps;
}

template <typename TQ, bool PARTIALS>
using CombineFn = void (*)(const float*, TQ*, float*, int, int);

// the combine kernel for head dim d: DPAD the power of two in [32, 256]
// that holds d, float2 reads when d is even and ws 8-byte aligned (a
// contiguous view may start at any float)
template <typename TQ, bool PARTIALS, int DPAD>
CombineFn<TQ, PARTIALS> combine_at(int d, const float* ws) {
  if (d % 2 == 0 && reinterpret_cast<uintptr_t>(ws) % 8 == 0)
    return combine_kernel<TQ, PARTIALS, DPAD, 2>;
  return combine_kernel<TQ, PARTIALS, DPAD, 1>;
}
template <typename TQ, bool PARTIALS>
CombineFn<TQ, PARTIALS> combine_for(int d, const float* ws) {
  if (d <= 32) return combine_at<TQ, PARTIALS, 32>(d, ws);
  if (d <= 64) return combine_at<TQ, PARTIALS, 64>(d, ws);
  if (d <= 128) return combine_at<TQ, PARTIALS, 128>(d, ws);
  return combine_at<TQ, PARTIALS, 256>(d, ws);
}

// a CTA of combine_warps(n_chunks) warps for each of the bh (b, h)
template <typename TQ, bool PARTIALS>
cudaError_t launch_combine_t(const float* ws, TQ* out, float* part, int bh,
                             int n_chunks, int d, cudaStream_t stream) {
  const CombineFn<TQ, PARTIALS> kernel = combine_for<TQ, PARTIALS>(d, ws);
  kernel<<<(unsigned)bh, 32 * combine_warps(n_chunks), 0, stream>>>(
      ws, out, part, n_chunks, d);
  return cudaGetLastError();
}

// the merge of n_chunks partial rows per (b, h) of ws into out (q's dtype)
// or, with part, into one partial row per (b, h)
cudaError_t launch_combine(const float* ws, void* out, float* part, int bh,
                           int n_chunks, int d, int out_bf16,
                           cudaStream_t stream) {
  if (part)
    return launch_combine_t<float, true>(ws, nullptr, part, bh, n_chunks, d,
                                         stream);
  if (out_bf16)
    return launch_combine_t<bf16, false>(ws, static_cast<bf16*>(out),
                                         nullptr, bh, n_chunks, d, stream);
  return launch_combine_t<float, false>(ws, static_cast<float*>(out),
                                        nullptr, bh, n_chunks, d, stream);
}

// The arguments outside the split kernels' contract, or the route's
// alignment, give cudaErrorInvalidValue.
bool valid_split(const Args& a, int q_bf16, int kv_bf16, int tensor_core) {
  if (a.b < 1 || a.s < 1 || a.d < 1 || a.d > kMaxHeadDim || a.hkv < 1 ||
      a.h < a.hkv || a.h % a.hkv != 0 || a.chunk < 1 || a.n_chunks < 1 ||
      (long long)a.chunk * a.n_chunks < a.s ||
      (long long)a.chunk * (a.n_chunks - 1) >= a.s || a.offset < 0 ||
      (a.b > 1 && a.batch_stride < (long long)a.s * a.hkv * a.d))
    return false;
  return !tensor_core || (q_bf16 && kv_bf16 && a.d % 16 == 0 &&
                          aligned16(a, 2));
}

}  // namespace

extern "C" {

int cemr_flash_decode_max_head_dim() { return kMaxHeadDim; }
int cemr_flash_decode_max_heads_per_cta() { return kHeads; }

// Dynamic shared memory of the split kernel that these arguments select
// (ptxas -v reports static shared memory only).
int cemr_flash_decode_smem_bytes(int d, int q_bf16, int kv_bf16,
                                 int tensor_core) {
  return with_route(d, q_bf16, kv_bf16, tensor_core,
                    [](auto route) { return decltype(route)::kSmem; });
}

const char* cemr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q (B, H, D), k and v (B, S, Hkv, D), out (B, H, D), all contiguous;
// lengths (B,) int32 or NULL (= S). q_bf16 / kv_bf16 select bfloat16 over
// float32 for q and out / for k and v. tensor_core selects the mma route
// (bf16 q and cache, D a multiple of 16, 16-byte aligned k and v). The
// positions split into n_chunks chunks of `chunk`; with n_chunks > 1, ws
// is an fp32 workspace (B, H, n_chunks, D + 2) for the partials and a
// second kernel merges them. *n_launched is set to the number of kernels
// launched without error (1: the split kernel, 2: and the combine).
// Returns the first non-zero cudaGetLastError() after a launch
// (0 = cudaSuccess), or cudaErrorInvalidValue for arguments outside the
// contract.
int cemr_flash_decode(const void* q, const void* k, const void* v,
                      const int32_t* lengths, void* out, float* ws, int b,
                      int h, int hkv, int s, int d, int chunk, int n_chunks,
                      float scale, int q_bf16, int kv_bf16, int tensor_core,
                      void* stream, int* n_launched) {
  *n_launched = 0;
  const Args a{q, k, v, lengths, out, n_chunks > 1 ? ws : nullptr, b, h,
               hkv, s, d, chunk, n_chunks, scale, (long long)s * hkv * d, 0,
               (cudaStream_t)stream};
  if (!valid_split(a, q_bf16, kv_bf16, tensor_core) || (n_chunks > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      with_route(d, q_bf16, kv_bf16, tensor_core,
                 [&a](auto route) { return decltype(route)::run(a); });
  if (err != cudaSuccess) return (int)err;
  *n_launched = 1;
  if (n_chunks == 1) return 0;
  err = launch_combine(a.ws, out, nullptr, b * h, n_chunks, d, q_bf16,
                       a.stream);
  if (err == cudaSuccess) *n_launched = 2;
  return (int)err;
}

// The partials of one block of cache positions [offset, offset + S): k
// and v (B, S, Hkv, D) with rows of Hkv * D contiguous elements and
// batch_stride elements from one batch row to the next (a view along S of
// a longer cache), lengths (B,) int32 of the whole row or NULL (every
// position of the block valid). Positions offset + p < lengths[b] count,
// so the block's length is clamp(lengths[b] - offset, 0, S), worked out
// by each CTA. The split kernel always writes the workspace ws (B, H,
// n_chunks, D + 2), one chunk or many, and the combine merges its chunks
// into part (B, H, D + 2) fp32: acc[D], m, l per (b, h); a (b, h) with no
// position in the block gives (0, -inf, 0). Returns and sets *n_launched
// as cemr_flash_decode does.
int cemr_flash_decode_partials(const void* q, const void* k, const void* v,
                               const int32_t* lengths, float* ws,
                               float* part, int b, int h, int hkv, int s,
                               int d, long long batch_stride, int offset,
                               int chunk, int n_chunks, float scale,
                               int q_bf16, int kv_bf16, int tensor_core,
                               void* stream, int* n_launched) {
  *n_launched = 0;
  const Args a{q, k, v, lengths, nullptr, ws, b, h, hkv, s, d, chunk,
               n_chunks, scale, batch_stride, offset, (cudaStream_t)stream};
  if (!valid_split(a, q_bf16, kv_bf16, tensor_core) || !ws || !part)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      with_route(d, q_bf16, kv_bf16, tensor_core,
                 [&a](auto route) { return decltype(route)::run(a); });
  if (err != cudaSuccess) return (int)err;
  *n_launched = 1;
  err = launch_combine(ws, nullptr, part, b * h, n_chunks, d, 0, a.stream);
  if (err == cudaSuccess) *n_launched = 2;
  return (int)err;
}

// out (B, H, D) in bf16 (out_bf16) or fp32 from n partial rows per (b, h):
// parts (B, H, n, D + 2) fp32, contiguous, as cemr_flash_decode_partials
// writes them. A (b, h) whose n rows are all empty gives 0/0 = NaN.
int cemr_flash_decode_merge(const float* parts, void* out, int b, int h,
                            int n, int d, int out_bf16, void* stream) {
  if (b < 1 || h < 1 || n < 1 || d < 1 || d > kMaxHeadDim)
    return (int)cudaErrorInvalidValue;
  return (int)launch_combine(parts, out, nullptr, b * h, n, d, out_bf16,
                             (cudaStream_t)stream);
}

}  // extern "C"
