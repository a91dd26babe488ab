// Schmidl-Cox sliding-window sums for Hopper (sm_90a), one thread block per
// (lane, tile of TILE outputs).
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
// The sums follow the block-grid order of detect_preamble: each stride-block
// k is first reduced to its energy eb[k] = sum_j |a[s*k+j]|^2 and its
// correlation ub[k] = sum_j conj(a[s*k+j]) * a[s*k+j+half], then every
// output adds half/stride consecutive block partials left to right.  At
// stride 1 the blocks are single samples.  No sum is longer than the
// window and nothing is a difference of two running sums, so the result
// stays block-stable on buffers of any length (no global float32 cumsum).
//
// The TPU kernel's log-depth shift-doubling existed because cumsum had no
// Pallas lowering; it is not carried over.
//
// What bounds it on this card: device memory is read once (each tile loads
// its stride * (TILE + 2*half/stride - 1) samples, so neighbouring tiles
// re-read a 2*half overlap) and a few bytes are written per output; at
// stride 1 the sequential window loops (half adds of four floats per
// output, read from shared memory) dominate instead.  The design stages a
// tile's samples and block partials in shared memory (13 KB at stride 1 and
// 24 KB at stride 8 for half = 256) so that all window loops read on-chip
// memory.  Measured on an H100 (B = 512, T = 18,856, stride 8) it moves
// ~96 MB in 0.107 ms, ~0.9 TB/s: the staging and the bank-conflicted
// stride-8 pre-reduction, not device memory, are its limit.  Coalesced
// 16-byte loads, a conflict-free pre-reduction, a prefix form of the window
// loop and fusing the metric into the epilogue are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;  // outputs (and threads) per block

__global__ void __launch_bounds__(kTile)
sc_windows_kernel(const float2* __restrict__ a, long long lda, int T,
                  int half, int stride, int offset, int G,
                  float2* __restrict__ P, float* __restrict__ R1,
                  float* __restrict__ R2) {
  extern __shared__ float2 smem[];
  const int b = blockIdx.x;
  const int g0 = blockIdx.y * kTile;
  const int hb = half / stride;          // block partials per window
  const int n_e = kTile + 2 * hb - 1;    // block energies the tile reads
  const int n_u = kTile + hb - 1;        // block correlations the tile reads
  const int n_s = stride * n_e;          // samples the tile reads
  float2* s_a = smem;
  float2* s_u = s_a + n_s;
  float* s_e = reinterpret_cast<float*>(s_u + n_u);

  const float2* row = a + (long long)b * lda;
  const long long d0 = (long long)offset + (long long)stride * g0;
  for (int i = threadIdx.x; i < n_s; i += blockDim.x) {
    const long long t = d0 + i;
    s_a[i] = t < T ? row[t] : make_float2(0.f, 0.f);  // ragged tile end
  }
  __syncthreads();

  for (int k = threadIdx.x; k < n_e; k += blockDim.x) {
    const float2* x = s_a + (long long)k * stride;
    float e = 0.f;
    for (int j = 0; j < stride; ++j) e += x[j].x * x[j].x + x[j].y * x[j].y;
    s_e[k] = e;
  }
  for (int k = threadIdx.x; k < n_u; k += blockDim.x) {
    const float2* x = s_a + (long long)k * stride;
    const float2* y = x + half;
    float ur = 0.f, ui = 0.f;
    for (int j = 0; j < stride; ++j) {
      ur += x[j].x * y[j].x + x[j].y * y[j].y;
      ui += x[j].x * y[j].y - x[j].y * y[j].x;
    }
    s_u[k] = make_float2(ur, ui);
  }
  __syncthreads();

  const int l = threadIdx.x;
  const int g = g0 + l;
  if (g >= G) return;
  float pr = 0.f, pi = 0.f, r1 = 0.f, r2 = 0.f;
  for (int m = 0; m < hb; ++m) {
    const float2 u = s_u[l + m];
    pr += u.x;
    pi += u.y;
    r1 += s_e[l + m];
    r2 += s_e[l + hb + m];
  }
  const long long o = (long long)b * G + g;
  P[o] = make_float2(pr, pi);
  R1[o] = r1;
  R2[o] = r2;
}

// Shared-memory bytes one block needs, or 0 when the arguments are invalid.
size_t smem_bytes(int half, int stride) {
  if (stride < 1 || half < stride || half % stride != 0) return 0;
  const size_t hb = (size_t)(half / stride);
  const size_t n_e = kTile + 2 * hb - 1;
  const size_t n_u = kTile + hb - 1;
  return (stride * n_e + n_u) * sizeof(float2) + n_e * sizeof(float);
}

}  // namespace

extern "C" {

// Launches the window sums for B lanes on `stream`, which belongs to the
// calling thread's current CUDA device; returns the CUDA error code of the
// launch (0 on success).  The caller guarantees
// offset + stride * (G - 1) + 2 * half <= T and offset % stride == 0.
int sc_windows_launch(const void* a, long long lda, int B, int T, int half,
                      int stride, int offset, int G, void* P, void* R1,
                      void* R2, void* stream) {
  const size_t smem = smem_bytes(half, stride);
  if (smem == 0 || B < 0 || G < 0 || offset < 0 || offset % stride != 0 ||
      (G > 0 && (long long)offset + (long long)stride * (G - 1) + 2LL * half >
                    (long long)T))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || G == 0) return 0;
  const int tiles = (G + kTile - 1) / kTile;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sc_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sc_windows_kernel<<<dim3(B, tiles), kTile, smem, (cudaStream_t)stream>>>(
      (const float2*)a, lda, T, half, stride, offset, G, (float2*)P,
      (float*)R1, (float*)R2);
  return (int)cudaGetLastError();
}

const char* sc_windows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
