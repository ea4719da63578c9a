// Hopper (sm_90a) kernel for single-token GQA decode attention:
//
//     out[b, h, :] = softmax_{p < len_b}( q[b, h, :] . k[b, p, h / G, :]
//                                         * scale ) @ v[b, :, h / G, :]
//
// with G = H / Hkv query heads per KV head, len_b = lengths[b] (S when no
// lengths are given), fp32 accumulation throughout and the output cast to
// q's dtype. It replaces the TPU kernel
//   src/repro/kernels/flash_decode.py : flash_decode_pallas (body _kernel)
// which walks the cache in S-blocks along a sequential grid axis and
// carries the online-softmax state (m, l, acc) in scratch memory.
//
// Bound on this card: memory. Each (b, h) reads len_b rows of K and V
// (2 * len_b * D elements) for about 4 * len_b * D flops, so the function
// must move sum_b len_b * Hkv * D * 2 * sizeof(cache) bytes at 3.35 TB/s;
// the fp32 flops sit far below the CUDA cores' rate.
//
// Design (simple first): one CTA per (b, h), kWarps warps. The warps take
// interleaved tiles of kRows key positions: tile t of warp w covers
// positions (t * kWarps + w) * kRows + u, u < kRows. A lane holds the
// dims d = lane + 32 * j of q and of its running acc, so a row load is
// coalesced and D < 32 leaves the upper lanes idle. Per tile a warp loads
// kRows K rows and kRows V rows (all loads in flight together), reduces
// the kRows dot products with __shfl_xor_sync, and updates its own
// running (m, l, acc). Positions at or past len_b are never loaded: they
// would contribute exp(-1e30 - m) = 0 in the TPU kernel. At the end the
// warps' partials merge in shared memory, each rescaled by exp(m_w - m).
//
// Every KV head is read once per query head (G times in all) and the loads
// are 2 to 4 bytes a lane; splitting S across CTAs (flash-decoding),
// reading each KV head once for its G query heads, and 16-byte or TMA
// loads are later work.
//
// Contract: 1 <= lengths[b] <= S. A larger length is clamped to S; a row
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

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;                 // key positions per warp per tile
constexpr int kMaxHeadDim = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);                  // round to nearest even
}

// VPL = values per lane: lane holds dims lane + 32 * j, j < VPL.
template <typename TQ, typename TKV, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v,
                    const int32_t* __restrict__ lengths,
                    TQ* __restrict__ out, int n_heads, int n_kv, int seq,
                    int head_dim, float scale) {
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxHeadDim];

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int len = lengths ? lengths[b] : seq;
  len = len < 0 ? 0 : (len > seq ? seq : len);

  float qr[VPL], acc[VPL];
  const TQ* qrow = q + (long long)bh * head_dim;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int d = lane + 32 * j;
    qr[j] = d < head_dim ? to_float(qrow[d]) : 0.f;
    acc[j] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  // row p of head kvh of batch b starts at ((b * S + p) * Hkv + kvh) * D
  const long long row_stride = (long long)n_kv * head_dim;
  const TKV* kbase = k + ((long long)b * seq * n_kv + kvh) * head_dim;
  const TKV* vbase = v + ((long long)b * seq * n_kv + kvh) * head_dim;

  for (int p0 = warp * kRows; p0 < len; p0 += kWarps * kRows) {
    float kr[kRows][VPL], vr[kRows][VPL], s[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const bool valid = p0 + u < len;
      const TKV* krow = kbase + (long long)(p0 + u) * row_stride;
      const TKV* vrow = vbase + (long long)(p0 + u) * row_stride;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int d = lane + 32 * j;
        const bool in = valid && d < head_dim;
        kr[u][j] = in ? to_float(__ldg(krow + d)) : 0.f;
        vr[u][j] = in ? to_float(__ldg(vrow + d)) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) dot += qr[j] * kr[u][j];
      s[u] = dot;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    }
    // p0 < len, so row u = 0 is always valid: tile_max is finite
    float tile_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      s[u] = p0 + u < len ? s[u] * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[u]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);           // m = -inf gives 0
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      s[u] = expf(s[u] - m_new);                   // masked rows give 0
      psum += s[u];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      float a = acc[j] * alpha;
#pragma unroll
      for (int u = 0; u < kRows; ++u) a += s[u] * vr[u][j];
      acc[j] = a;
    }
    m = m_new;
  }

  // merge the warps' partials; a warp that saw no position has m = -inf
  // and weight 0
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int d = lane + 32 * j;
    if (d < head_dim) sm_acc[warp][d] = acc[j];
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < head_dim) {
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w]);
    float l_all = 0.f, a_all = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - m_all);
      l_all += sm_l[w] * c;
      a_all += sm_acc[w][t] * c;
    }
    out[(long long)bh * head_dim + t] = from_float<TQ>(a_all / l_all);
  }
}

template <typename TQ, typename TKV>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int32_t* lengths, void* out, int b, int h,
                         int hkv, int s, int d, float scale,
                         cudaStream_t stream) {
  const dim3 grid((unsigned)(b * h));
  const dim3 block(kWarps * 32);
  const TQ* qp = static_cast<const TQ*>(q);
  const TKV* kp = static_cast<const TKV*>(k);
  const TKV* vp = static_cast<const TKV*>(v);
  TQ* op = static_cast<TQ*>(out);
  if (d <= 32)
    flash_decode_kernel<TQ, TKV, 1><<<grid, block, 0, stream>>>(
        qp, kp, vp, lengths, op, h, hkv, s, d, scale);
  else if (d <= 64)
    flash_decode_kernel<TQ, TKV, 2><<<grid, block, 0, stream>>>(
        qp, kp, vp, lengths, op, h, hkv, s, d, scale);
  else if (d <= 128)
    flash_decode_kernel<TQ, TKV, 4><<<grid, block, 0, stream>>>(
        qp, kp, vp, lengths, op, h, hkv, s, d, scale);
  else
    flash_decode_kernel<TQ, TKV, 8><<<grid, block, 0, stream>>>(
        qp, kp, vp, lengths, op, h, hkv, s, d, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cemr_flash_decode_max_head_dim() { return kMaxHeadDim; }

const char* cemr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q (B, H, D), k and v (B, S, Hkv, D), out (B, H, D), all contiguous;
// lengths (B,) int32 or NULL (= S). q_bf16 / kv_bf16 select bfloat16 over
// float32 for q and out / for k and v. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess), or cudaErrorInvalidValue for shapes outside
// the contract.
int cemr_flash_decode(const void* q, const void* k, const void* v,
                      const int32_t* lengths, void* out, int b, int h,
                      int hkv, int s, int d, float scale, int q_bf16,
                      int kv_bf16, void* stream) {
  if (b < 1 || s < 1 || d < 1 || d > kMaxHeadDim || hkv < 1 || h < hkv ||
      h % hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (q_bf16 && kv_bf16)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(q, k, v, lengths, out,
                                                     b, h, hkv, s, d, scale,
                                                     st);
  else if (q_bf16)
    err = launch_typed<__nv_bfloat16, float>(q, k, v, lengths, out, b, h,
                                             hkv, s, d, scale, st);
  else if (kv_bf16)
    err = launch_typed<float, __nv_bfloat16>(q, k, v, lengths, out, b, h,
                                             hkv, s, d, scale, st);
  else
    err = launch_typed<float, float>(q, k, v, lengths, out, b, h, hkv, s, d,
                                     scale, st);
  return (int)err;
}

}  // extern "C"
