// Chirp acquisition's decimation for Hopper (sm_90a): the 128-tap complex
// band-select FIR of sync/chirp._decimate, keeping every 8th output, in one
// launch that reads each sample from device memory once.
//
// It replaces no TPU kernel.  It stands for XLA's convolution in
// projectultra_tpu/sync/chirp.py:174-200 (_decimate's polyphase conv) and,
// in the port, for the five eager operations of the plain version
// (sync/chirp._decimate_plain: a pad, the polyphase reshape/transpose copy, a
// second pad, cuDNN's generic implicit_convolve_sgemm for 8 input and 2
// output channels of width 16, and torch.complex).  It was added on a
// measurement: on an H100 at the acquired benchmark cell's shape (B = 2,048
// buffers of T = 83,808 samples) those five took 9.42 ms a batch, a third of
// the step and 2.7% of the stage's bound.
//
// For row b and output m < Tb = ceil(T / 8), with x = 0 outside [0, T):
//   y[b, m] = sum_{k<128} w[k] * x[b, 8m + k - 64]
// where w = (w_re, w_im) are the two real rows of _decim_filter.  y is
// written as interleaved (re, im) float2 into a complex64 [B, Tb] tensor.
// Each of re and im is one chain of float32 fused multiply-adds over
// k = 0..127 in order, starting from 0: no TF32, no other rounding.  The
// plain version sums the same products in cuDNN's order, so the two differ
// by float32 rounding only; a NaN or infinite sample makes non-finite
// exactly the outputs whose windows hold it, in both.
//
// The bf16 mode (kBf16) rounds each staged sample to bfloat16
// (__float2bfloat16_rn) before the float32 products, as the plain version
// rounds its operands; the launch rounds the taps the same way on the host,
// once, before they enter the kernel's parameters.
//
// What bounds it on this card.  Device memory: it reads B*T*4 bytes and
// writes B*Tb*8: at the cell's shape 686.6 + 171.6 MB, 0.256 ms at
// 3.35 TB/s.  Its 256 float32 fused multiply-adds an output (11.0 GFLOP at
// the cell) take 0.164 ms at 67 TFLOP/s: two thirds of the bytes' time, so
// the design keeps every instruction other than the products off the
// critical path.
//
// The design:
//   * Tiles.  A block owns `tile` consecutive outputs of one row (a
//     multiple of kPerThread, at most kMaxThreads * kPerThread = 512).
//     ops/cuda_decimate.py::tile_for picks it from B, T and the SM count
//     alone: tiles of up to 512 outputs, cut down (to 128, one warp) while
//     the grid would give fewer than four blocks an SM, and as equal along a
//     row as multiples of 4 allow.  The cell: 21 tiles of 500 a row, 43,008
//     blocks of 128 threads; the engine's B = 1 search view (T = 262,144):
//     256 blocks of one warp.
//   * Staging.  The block's outputs read the 8 * n + 120 samples from
//     8 * m0 - 64 on.  Every thread issues cp.async copies of 16 bytes
//     (neighbouring threads on neighbouring 16 bytes: coalesced), all in
//     flight before one wait, with the copy's source size giving zeros in
//     place of samples outside [0, T): no padded copy is ever made.  A row
//     whose start is not 16-byte aligned (T = 20,003: every odd row) takes
//     copies of 4 bytes instead.  Other resident blocks compute while one
//     block's copies are in flight (ten blocks of 128 threads an SM, at 48
//     registers a thread).
//   * Products.  Thread i sums the kPerThread = 4 consecutive outputs
//     m0 + 4i .. m0 + 4i + 3 in 8 float32 accumulators.  Their windows
//     cover 152 consecutive samples, which it reads once each from shared
//     memory (38 16-byte loads for 1,024 fused multiply-adds) and feeds to
//     every accumulator whose window holds the sample.  The loops are fully
//     unrolled, so each tap's index is a constant: the taps ride in the
//     kernel's parameters (the constant bank), the same for the whole warp,
//     and reach the FFMAs through uniform registers.  Eight outputs a thread
//     (16 accumulators, 46 loads for 2,048 FMAs) measured slower on the
//     H100: 0.388 ms at the cell at 128 registers (0.878 ms held to 80,
//     with spills) against 0.348-0.353 ms at 48 registers.
//   * Shared memory layout.  Neighbouring threads' windows start 32 samples
//     apart, which would put a quarter-warp's 16-byte loads in two bank
//     groups; every run of 32 staged samples is followed by 4 unused words
//     (sample s at word s + 4 * (s / 32)), which spreads the eight loads of
//     a quarter-warp over all 32 banks.  Outputs leave the same way: each
//     thread writes its 4 complex values to shared memory (4 unused words
//     every 32), then the block writes its run of the row as consecutive
//     float2, a warp's 256 bytes at a time.
//   * Shared memory: (36 * threads + 136) floats, 18,976 B for 128
//     threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDecim = 8;                      // keep every 8th output
constexpr int kTaps = 128;                     // taps of the FIR
constexpr int kHalf = kTaps / 2;               // the window's lead, 64
constexpr int kPerThread = 4;                  // outputs a thread sums
constexpr int kWarp = 32;
constexpr int kMaxThreads = 4 * kWarp;         // threads a block, at most
constexpr int kMaxTile = kMaxThreads * kPerThread;
constexpr int kStride = kDecim * kPerThread;   // samples between windows
constexpr int kHalo = kTaps - kDecim;          // 120
constexpr int kChunks = (kStride + kHalo) / kDecim;  // 19 runs of 8 samples
constexpr int kTapChunks = kTaps / kDecim;     // 16
constexpr int kSkew = 4;                       // unused words a run

struct Taps {
  float re[kTaps];
  float im[kTaps];
};

struct Params {
  const float* x;  // [B, T] float32, row stride ldx
  long long ldx;
  float2* y;       // [B, Tb] complex64 as (re, im), contiguous
  int T;
  int Tb;          // ceil(T / 8)
  int tile;        // outputs a block
  int tiles;       // blocks a row
  Taps w;
};

__host__ __device__ constexpr int threads_for(int tile) {
  return ((tile / kPerThread + kWarp - 1) / kWarp) * kWarp;
}

// Samples the threads of a block read (zeros past the block's own).
__host__ __device__ constexpr int staged_for(int threads) {
  return kStride * threads + kHalo;
}

size_t shared_bytes(int threads) {
  const int staged = staged_for(threads);
  return sizeof(float) *
         (size_t)(staged + kSkew * ((staged + kStride - 1) / kStride));
}

// The shared word of staged sample s, and of output float f.
__device__ __forceinline__ int staged_word(int s) {
  return s + kSkew * (s / kStride);
}
__device__ __forceinline__ int out_word(int f) {
  return f + kSkew * (f / kWarp);
}

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

template <bool kBf16>
__global__ void __launch_bounds__(kMaxThreads, 6)
chirp_decimate_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, threads = blockDim.x;
  const int b = (int)(blockIdx.x / (unsigned)p.tiles);
  const int m0 = (int)(blockIdx.x - (unsigned)b * p.tiles) * p.tile;
  const int n_out = min(p.tile, p.Tb - m0);
  const long long n0 = (long long)kDecim * m0 - kHalf;  // first sample
  const int need = kDecim * n_out + kHalo;  // samples these outputs read
  const int staged = staged_for(threads);
  const float* row = p.x + (long long)b * p.ldx;

  // Stage samples n0 .. n0 + staged - 1: the block's own, zeros elsewhere.
  // n0 is a multiple of 8, so a 16-byte run lies wholly below 0 or not.
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    for (int c = tid; c < staged / 4; c += threads) {
      const int s = 4 * c;
      const long long n = n0 + s;
      int valid = 0;
      if (s < need && n >= 0)
        valid = (int)max(0LL, min(4LL, (long long)p.T - n));
      copy16(sm + staged_word(s), valid ? row + n : row, 4 * valid);
    }
  } else {
    for (int s = tid; s < staged; s += threads) {
      const long long n = n0 + s;
      const bool valid = s < need && n >= 0 && n < p.T;
      copy4(sm + staged_word(s), valid ? row + n : row, valid ? 4 : 0);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (kBf16) {
    for (int s = tid; s < staged; s += threads) {
      float* v = sm + staged_word(s);
      *v = __bfloat162float(__float2bfloat16_rn(*v));
    }
    __syncthreads();
  }

  // Outputs m0 + 8*tid + r: sample 8*r + k of the thread's window meets
  // tap k, so run j of 8 samples meets tap run j - r.
  float re[kPerThread], im[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    re[r] = 0.0f;
    im[r] = 0.0f;
  }
  const float* win = sm + (kStride + kSkew) * tid;  // staged_word(64 * tid)
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const float* run = win + kDecim * j + kSkew * (j / kPerThread);
    const float4 lo = *reinterpret_cast<const float4*>(run);
    const float4 hi = *reinterpret_cast<const float4*>(run + 4);
    const float v[kDecim] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int kc = j - r;
      if (kc >= 0 && kc < kTapChunks) {
#pragma unroll
        for (int q = 0; q < kDecim; ++q) {
          re[r] = __fmaf_rn(p.w.re[kDecim * kc + q], v[q], re[r]);
          im[r] = __fmaf_rn(p.w.im[kDecim * kc + q], v[q], im[r]);
        }
      }
    }
  }

  // Through shared memory, so that the row is written in consecutive runs.
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPerThread / 2; ++q) {
    const int f = 2 * kPerThread * tid + 4 * q;
    *reinterpret_cast<float4*>(sm + out_word(f)) =
        make_float4(re[2 * q], im[2 * q], re[2 * q + 1], im[2 * q + 1]);
  }
  __syncthreads();
  float2* out = p.y + (long long)b * p.Tb + m0;
  for (int c = tid; c < n_out; c += threads)
    out[c] = *reinterpret_cast<const float2*>(sm + out_word(2 * c));
}

// Checks the arguments and fills p (the taps when taps != nullptr, rounded
// to bfloat16 for the bf16 mode); 0 or a CUDA error code.
int setup(Params* p, const void* x, long long ldx, int B, int T, int tile,
          const float* taps, int bf16, void* y) {
  if (B < 0 || T < 0 || T > 0x7fffff00 || tile < kPerThread ||
      tile > kMaxTile || tile % kPerThread != 0 ||
      (B > 1 && ldx < T) || (uintptr_t)x % 4 != 0 || (uintptr_t)y % 8 != 0)
    return (int)cudaErrorInvalidValue;
  p->x = (const float*)x;
  p->ldx = ldx;
  p->y = (float2*)y;
  p->T = T;
  p->Tb = (T + kDecim - 1) / kDecim;
  p->tile = tile;
  p->tiles = (p->Tb + tile - 1) / tile;
  if ((long long)B * p->tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (taps != nullptr) {
    for (int k = 0; k < kTaps; ++k) {
      float wr = taps[k], wi = taps[kTaps + k];
      if (bf16) {
        wr = __bfloat162float(__float2bfloat16_rn(wr));
        wi = __bfloat162float(__float2bfloat16_rn(wi));
      }
      p->w.re[k] = wr;
      p->w.im[k] = wi;
    }
  }
  return 0;
}

template <bool kBf16>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int threads = threads_for(p.tile);
  const size_t smem = shared_bytes(threads);
  cudaError_t err = cudaFuncSetAttribute(
      chirp_decimate_kernel<kBf16>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  chirp_decimate_kernel<kBf16>
      <<<(unsigned)((long long)B * p.tiles), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the decimation of B rows on `stream` (of the calling thread's
// current CUDA device); returns the CUDA error code of the launch (0 on
// success).  `taps` is a host array of the 2 x 128 float32 taps (the real
// row, then the imaginary row), copied into the kernel's parameters; bf16
// != 0 selects the bf16 mode.  y must be [B, ceil(T / 8)] complex64,
// contiguous.
int chirp_decimate_launch(const void* x, long long ldx, int B, int T,
                          int tile, const float* taps, int bf16, void* y,
                          void* stream) {
  Params p;
  const int bad = setup(&p, x, ldx, B, T, tile, taps, bf16, y);
  if (bad) return bad;
  if (B == 0 || T == 0) return 0;
  const cudaError_t err =
      bf16 ? launch<true>(p, B, (cudaStream_t)stream)
           : launch<false>(p, B, (cudaStream_t)stream);
  return (int)err;
}

// What chirp_decimate_launch would launch for these sizes on the current
// device: out[0] blocks, out[1] threads a block, out[2] dynamic shared
// bytes a block, out[3] blocks an SM can hold; returns the CUDA error code.
int chirp_decimate_plan(int B, int T, int tile, long long* out) {
  Params p;
  const int bad = setup(&p, (const void*)0, T, B, T, tile, nullptr, 0,
                        (void*)0);
  if (bad) return bad;
  const int threads = threads_for(tile);
  const size_t smem = shared_bytes(threads);
  cudaError_t err = cudaFuncSetAttribute(
      chirp_decimate_kernel<false>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, chirp_decimate_kernel<false>, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = (long long)B * p.tiles;
  out[1] = threads;
  out[2] = (long long)smem;
  out[3] = per_sm;
  return 0;
}

// The kernel's fixed sizes: taps, outputs a thread, threads a block.
int chirp_decimate_taps(void) { return kTaps; }
int chirp_decimate_per_thread(void) { return kPerThread; }
int chirp_decimate_max_threads(void) { return kMaxThreads; }

const char* chirp_decimate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
