// Schmidl-Cox sliding-window sums for Hopper (sm_90a), one thread block per
// (tile of 512 outputs, lane).
//
// Replaces the TPU kernel projectultra_tpu/ops/pallas_sync.py::_sc_kernel
// (called through sc_windows_pallas) and, at stride 8, the block-grid window
// sums of projectultra_tpu/sync/schmidl_cox.py::detect_preamble
// (schmidl_cox.py:200-219).  For lane b and output g < G, with
// d = offset + stride * g:
//   P[b, g]  = sum_{i<half} conj(a[b, d+i]) * a[b, d+i+half]
//   R1[b, g] = sum_{i<half} |a[b, d+i]|^2
//   R2[b, g] = sum_{i<half} |a[b, d+half+i]|^2
// from a complex64 analytic signal read as interleaved float2, row stride
// `lda` (the analytic signal is the first T columns of an [B, n_fft] ifft,
// so rows are not contiguous with each other), all in float32.
//
// The sums follow the block-grid form of detect_preamble: each stride-block
// k is first reduced to its energy eb[k] = sum_j |a[s*k+j]|^2 and its
// correlation ub[k] = sum_j conj(a[s*k+j]) * a[s*k+j+half], then every
// output adds its half/stride consecutive block partials left to right
// (R2[g] is R1[g + half/stride], the same partials in the same order).  At
// stride 1 the blocks are single samples.  No sum is longer than the window
// and nothing is a difference of two running sums, so the result stays
// block-stable on buffers of any length (no global float32 cumsum).
//
// The TPU kernel's log-depth shift-doubling existed because cumsum had no
// Pallas lowering; it is not carried over.
//
// What bounds it on this card: device memory.  At the Cox shape (B = 512,
// T = 18,856, stride 8, G = 2,288) the inputs are 77.2 MB and the outputs
// 18.7 MB, ~28.6 us at 3.35 TB/s; the window loops (half/stride adds of
// four floats per output, from shared memory) come second.  The first
// version staged a 256-output tile's samples in shared memory with 8-byte
// loads (a 25% halo re-read), then pre-reduced them with a 64-byte thread
// stride (16-way bank conflicts, twice), and ran at ~26% of the bound.
//
// The design:
//   * tiles of 512 outputs (two per thread), whose halo of
//     2*half/stride - 1 partials past the outputs is 12% of a tile at
//     stride 8; tiles of 256 and 1,024 measured slower at stride 8, the
//     detection shape, and 512 is faster than the first version at
//     stride 1 too;
//   * the pre-reduction reads the samples straight from device memory into
//     registers, one 16-byte float4 (two samples) per thread, neighbouring
//     threads on neighbouring addresses, the partner at +half likewise,
//     four pairs in flight per thread; the stride/2 lanes of one block
//     combine by warp shuffles, and only the block partials go to shared
//     memory (9-13 KB a block), so several blocks share an SM and their
//     loads overlap each other's window loops without a staging buffer;
//   * the window loops read the partials with consecutive threads on
//     consecutive outputs (conflict-free), two independent outputs per
//     thread, and R2 is read from R1 half/stride outputs on instead of
//     being summed twice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kOut = 2;        // outputs per thread
constexpr int kTile = kOut * kThreads;  // outputs per block
constexpr int kUnroll = 4;     // sample pairs a thread loads before using

__device__ __forceinline__ float4 load_pair(const float2* row, long long t,
                                            int T) {
  // Samples t, t+1 (t even); zero past the end of the row.
  if (t >= T) return make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v = __ldg(reinterpret_cast<const float4*>(row + t));
  if (t + 1 >= T) v.z = v.w = 0.f;
  return v;
}

// One block: lane blockIdx.y, outputs [g0, g0 + kTile).
__global__ void __launch_bounds__(kThreads)
sc_windows_kernel(const float2* __restrict__ a, long long lda, int T,
                  int half, int stride, int offset, int G,
                  float2* __restrict__ P, float* __restrict__ R1,
                  float* __restrict__ R2) {
  extern __shared__ float2 smem[];
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * kTile;
  const int hb = half / stride;          // block partials per window
  const int n_e = kTile + 2 * hb - 1;    // block energies the tile reads
  const int n_u = kTile + hb - 1;        // block correlations the tile reads
  const int n_r = kTile + hb;            // R1 outputs the tile sums
  float2* s_u = smem;                                      // [n_u]
  float* s_e = reinterpret_cast<float*>(s_u + n_u);        // [n_e]
  float* s_r = s_e + n_e;                                  // [n_r]

  const float2* row = a + (long long)b * lda;
  const long long t0 = (long long)offset + (long long)stride * g0;
  const long long tb = t0 & ~1LL;   // float4-aligned start (odd only at s=1)
  const int shift = (int)(t0 - tb);
  const int lanes = stride > 1 ? stride / 2 : 1;  // threads per block partial
  const int n_f = stride > 1 ? n_e * lanes : (n_e + shift + 1) / 2;

  // Pre-reduction: pair f holds samples tb + 2f, tb + 2f + 1; a thread
  // loads kUnroll pairs (and their partners half samples on) before it
  // reduces any of them.
  for (int f0 = 0; f0 < n_f; f0 += kUnroll * kThreads) {
    float4 x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f = f0 + u * kThreads + threadIdx.x;
      const long long t = tb + 2LL * f;
      const bool in = f < n_f;
      const bool corr = in && (stride == 1 || f / lanes < n_u);
      x[u] = in ? load_pair(row, t, T) : make_float4(0.f, 0.f, 0.f, 0.f);
      y[u] = corr ? load_pair(row, t + half, T)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f = f0 + u * kThreads + threadIdx.x;
      const bool in = f < n_f;
      const float4 xv = x[u], yv = y[u];
      if (stride > 1) {
        const int k = f / lanes;
        float e = xv.x * xv.x + xv.y * xv.y + (xv.z * xv.z + xv.w * xv.w);
        float ur = xv.x * yv.x + xv.y * yv.y + (xv.z * yv.z + xv.w * yv.w);
        float ui = xv.x * yv.y - xv.y * yv.x + (xv.z * yv.w - xv.w * yv.z);
        for (int o = 1; o < lanes; o <<= 1) {
          e += __shfl_xor_sync(0xffffffffu, e, o);
          ur += __shfl_xor_sync(0xffffffffu, ur, o);
          ui += __shfl_xor_sync(0xffffffffu, ui, o);
        }
        if (in && f % lanes == 0) {
          s_e[k] = e;
          if (k < n_u) s_u[k] = make_float2(ur, ui);
        }
      } else if (in) {
        const int k = 2 * f - shift;  // partial of the pair's first sample
        if (k >= 0 && k < n_e) s_e[k] = xv.x * xv.x + xv.y * xv.y;
        if (k + 1 < n_e) s_e[k + 1] = xv.z * xv.z + xv.w * xv.w;
        if (k >= 0 && k < n_u)
          s_u[k] = make_float2(xv.x * yv.x + xv.y * yv.y,
                               xv.x * yv.y - xv.y * yv.x);
        if (k + 1 < n_u)
          s_u[k + 1] = make_float2(xv.z * yv.z + xv.w * yv.w,
                                   xv.z * yv.w - xv.w * yv.z);
      }
    }
  }
  __syncthreads();

  // Window sums: thread l sums outputs l, l + 256, ...
  float pr[kOut], pi[kOut], r1[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) pr[o] = pi[o] = r1[o] = 0.f;
  for (int m = 0; m < hb; ++m) {
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const int l = threadIdx.x + o * kThreads + m;
      const float2 u = s_u[l];
      pr[o] += u.x;
      pi[o] += u.y;
      r1[o] += s_e[l];
    }
  }
#pragma unroll
  for (int o = 0; o < kOut; ++o) s_r[threadIdx.x + o * kThreads] = r1[o];
  // R1 of the hb outputs past the tile, which R2 of the tile reads.
  for (int l = kTile + threadIdx.x; l < n_r; l += kThreads) {
    float r = 0.f;
    for (int m = 0; m < hb; ++m) r += s_e[l + m];
    s_r[l] = r;
  }
  __syncthreads();

#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int l = threadIdx.x + o * kThreads;
    const int g = g0 + l;
    if (g < G) {
      const long long i = (long long)b * G + g;
      P[i] = make_float2(pr[o], pi[o]);
      R1[i] = r1[o];
      R2[i] = s_r[l + hb];
    }
  }
}

bool valid_stride(int half, int stride) {
  // stride 1, or an even power of two whose stride/2 lanes fit in a warp.
  const bool pow2 = stride >= 1 && (stride & (stride - 1)) == 0;
  return pow2 && stride <= 64 && half >= stride && half % stride == 0;
}

// Shared-memory bytes one block needs.
size_t smem_bytes(int half, int stride) {
  const size_t hb = (size_t)(half / stride);
  return (kTile + hb - 1) * sizeof(float2) +
         (2 * (size_t)kTile + 3 * hb - 1) * sizeof(float);
}

}  // namespace

extern "C" {

// Launches the window sums for B lanes on `stream`, which belongs to the
// calling thread's current CUDA device, in tiles of 512 outputs per block;
// returns the CUDA error code of the launch (0 on success).  The caller guarantees offset + stride * (G - 1) + 2 * half <=
// T, offset % stride == 0, a 16-byte aligned `a`, an even `lda` and an even
// `half`.
int sc_windows_launch(const void* a, long long lda, int B, int T, int half,
                      int stride, int offset, int G, void* P,
                      void* R1, void* R2, void* stream) {
  if (!valid_stride(half, stride) || half % 2 != 0 || B < 0 || G < 0 ||
      offset < 0 || offset % stride != 0 || lda % 2 != 0 ||
      (uintptr_t)a % 16 != 0 ||
      (G > 0 && (long long)offset + (long long)stride * (G - 1) + 2LL * half >
                    (long long)T))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || G == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(half, stride);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sc_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (G + kTile - 1) / kTile;
  sc_windows_kernel<<<dim3(tiles, B), kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)a, lda, T, half, stride, offset, G, (float2*)P,
      (float*)R1, (float*)R2);
  return (int)cudaGetLastError();
}

const char* sc_windows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
