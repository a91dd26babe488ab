// Schmidl-Cox LTS fine timing for Hopper (sm_90a): the matched filter, its
// energy normalisation, the masked argmax and the one-symbol rule of
// sync/schmidl_cox.detect_preamble, evaluated only at the positions of each
// lane's search window, in one launch.
//
// It replaces no TPU kernel.  It stands for the XLA operations of the LTS
// stage of projectultra_tpu/sync/schmidl_cox.py::detect_preamble (the
// matched filter as ifft(X * conj(fft(conj(template)))) over the whole
// buffer, the full-rate window energy, the normalised filter and the masked
// argmax) and, in the port, for the ~40 eager operations of the plain
// version (sync/schmidl_cox.lts_timing_plain: a third 32,768-point FFT, the
// L = 560 window sums' cumulative scans, the normalisation and the masks
// over [B, T - L + 1] arrays).  It was added on a measurement: on an H100 at
// the Cox benchmark cell's shape (B = 2,048 buffers of T = 18,856 samples)
// detection took 10.45 ms of an 18 ms step, and the scans were the largest
// operation of the step, yet the result reads only the ~1,961 positions of
// each lane's window (10.7% of the 18,297).
//
// For lane b, with plen the symbol length, L = plen the template's length
// and n_mf = T - L + 1 positions of the filter:
//   coarse = sync_off[b] + 4 * plen
//   the window [lo, hi] = [coarse - 3 * plen, coarse + plen / 2] clipped to
//   [0, n_mf); position 0 alone when that is empty (the plain argmax of an
//   all -1 row)
//   mf[p]  = | sum_{i<L} x[p + i] * t[i] |   (t complex, x real)
//   E[p]   = sum_{i<L} x[p + i]^2
//   nmf[p] = E[p] * e_ref > 1e-12 ? mf[p] / sqrt(max(E[p] * e_ref, 1e-30))
//                                 : 0
//   lts = the first position of the window holding its largest nmf (NaN
//   counting as the largest, as torch.argmax takes it)
//   if lts - plen >= coarse - 3 * plen (unclipped) and
//      nmf[clamp(lts - plen)] >= 0.85 * nmf[lts]: lts = lts - plen
// and writes lts_start = lts, data_start = lts + 2 * plen (int32) and
// lts_corr = nmf[lts] (float32).  mf is the plain version's matched filter
// without the FFT: each of its real and imaginary parts is one chain of
// float32 fused multiply-adds over i in order, so the two differ by float32
// rounding.  E[p] is a sum of the window's own L squares (no differenced
// prefix sum), so a window over zeros reads exactly 0, as the plain
// window_sum's does.  A lane holding a NaN or infinite sample has a NaN
// matched filter at every position in the plain version (the FFT spreads
// it); the kernel reads that from the lane's DC bin of the signal FFT
// (finite exactly when the FFT saw only finite samples) and takes mf = NaN
// there, so that nmf follows the same rule with its own energies.
//
// What bounds it on this card.  Operations: 2 * L float32 fused
// multiply-adds a position (4 float32 operations a tap): at the cell's
// 1,961 positions and L = 560, 9.0 GFLOP over 2,048 lanes, 0.134 ms at
// 67 TFLOP/s.  Its bytes (the window's 2,520 samples a lane, 20.6 MB) take
// 6 us at 3.35 TB/s.  So the design keeps the fused multiply-adds fed from
// registers.
//
// The design:
//   * One block of kThreads threads a lane.  Its window's samples
//     (P + L - 1 of them) and the template (L complex values) are staged in
//     shared memory by cp.async copies all in flight before one wait, with
//     zeros past the window's samples.
//   * Thread k owns kPer = 16 consecutive positions 16k .. 16k + 15 of the
//     window (and 16 (k + kThreads) .. on a later pass, for windows of more
//     than 2,048 positions).  It walks the taps kStep = 4 at a time with the
//     20 samples they meet in registers (five 16-byte loads at the start,
//     one a step after), reading each tap pair once as a 16-byte broadcast
//     (every thread of the block reads the same taps at the same step), and
//     keeps 32 accumulators: 128 fused multiply-adds a step against three
//     shared loads.  That takes 115 registers, so four blocks of 128
//     threads an SM; measured on the H100 at the Cox cell (the same
//     outputs): 0.278 ms a launch, against 0.315 ms for 8 positions a
//     thread in blocks of 256 at 64 registers, 0.281 ms for 8 positions and
//     8 taps a step at 71, and 0.296 ms for 16 positions held to 80
//     registers (spilling).
//   * The energies ride along: the squares of the samples 16 .. L - 1 of
//     the thread's run (common to its sixteen windows) are summed as they
//     are loaded; the head (samples r .. 15) and the tail (samples
//     L .. L + r - 1) of window r are added at the end.  No term is ever
//     subtracted.
//   * Shared memory layout.  Neighbouring threads read 16 bytes 64 bytes
//     apart, which would put two threads of a quarter-warp on the same
//     banks; the staged samples are swizzled at 16-byte granularity within
//     each run of 32 words (float4 u of a run at slot
//     (u / 4 + 2 (u % 4)) mod 8), which spreads the eight 16-byte loads of
//     a quarter-warp over all 32 banks at every step.
//   * Each thread writes its positions' nmf to shared memory and keeps its
//     own first largest; a warp shuffle and one pass over the warps' winners
//     give the block's, and one thread applies the one-symbol rule from the
//     shared nmf and writes the lane's three outputs.
//   * Shared memory: (16 ceil(Pmax / 16) + L rounded up to 32) + 2 L +
//     16 ceil(Pmax / 16) + 2 kWarps words, Pmax = 3 plen + plen / 2 + 1 the
//     widest window: 22,496 B at plen = 560, 46,304 B at plen = 1,152.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kPer = 16;                    // window positions a thread
constexpr int kStep = 4;                    // taps a step
constexpr int kThreads = 128;               // threads a block
constexpr int kMinBlocks = 4;               // blocks an SM (128 registers)
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kRun = kPer / 4;              // float4s between threads' runs
constexpr int kWin = (kPer + kStep) / 4;    // float4s a step reads
constexpr int kNew = kStep / 4;             // float4s a step adds
static_assert(kPer % 4 == 0 && kStep % 4 == 0 && kPer % kStep == 0 &&
                  8 % kRun == 0,
              "positions and taps come in whole float4s");
constexpr int kDefaultSharedMax = 48 * 1024;

struct Params {
  const float* x;          // [B, T] float32, row stride ldx
  long long ldx;
  int T;
  int L;                   // template length (a multiple of 8)
  int plen;                // symbol length (CP + N)
  int n_mf;                // T - L + 1
  float e_ref;             // the template's energy / 2, as float32
  const float4* tmpl;      // [L] complex64: (re, im) pairs, two a float4
  const long long* sync_off;  // [B]
  const float2* dc;        // the signal FFT's DC bin of each lane
  long long ld_dc;         // its stride between lanes, in complex values
  int* lts_start;          // [B]
  int* data_start;         // [B]
  float* lts_corr;         // [B]
  int staged;              // shared words of samples (a multiple of 32)
  int positions;           // shared words of nmf
};

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The widest window: [coarse - 3 plen, coarse + plen / 2].
__host__ __device__ constexpr int max_positions(int plen) {
  return 3 * plen + plen / 2 + 1;
}

__host__ __device__ constexpr int position_words(int plen) {
  return round_up(max_positions(plen), kPer);
}

// A thread's run reads samples up to kPer ceil(P / kPer) + L - 1 of the
// window.
__host__ __device__ constexpr int staged_words(int plen, int L) {
  return round_up(position_words(plen) + L, kWarp);
}

size_t shared_bytes(int plen, int L) {
  return sizeof(float) * ((size_t)staged_words(plen, L) + 2 * (size_t)L +
                          position_words(plen) + 2 * kWarps);
}

// The shared float4 slot of the window's float4 u (samples 4u .. 4u + 3):
// within each run of 8 float4s, u / kRun + (8 / kRun) (u % kRun) mod 8, so
// that the float4s kRun apart that a quarter-warp reads at one step land in
// 8 different slots of 4 banks.
__device__ __forceinline__ int slot(int u) {
  return (u & ~7) | ((u / kRun + (8 / kRun) * (u % kRun)) & 7);
}

__device__ __forceinline__ int sample_word(int s) {
  return 4 * slot(s >> 2) + (s & 3);
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// (a, ia) before (b, ib) in torch.argmax's order: NaN above every number,
// the first index among equals.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool an = a != a, bn = b != b;
  if (an != bn) return an;
  if (an || a == b) return ia < ib;
  return a > b;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
lts_timing_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float4* taps = smem4 + p.staged / 4;
  float* nmf = reinterpret_cast<float*>(taps + p.L / 2);
  float* red_v = nmf + p.positions;
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);

  const int tid = threadIdx.x, b = blockIdx.x;
  const long long coarse = p.sync_off[b] + 4LL * p.plen;
  const long long lo = coarse - 3LL * p.plen;
  long long lo_c = lo > 0 ? lo : 0;
  long long hi_c = coarse + p.plen / 2;
  if (hi_c > p.n_mf - 1) hi_c = p.n_mf - 1;
  if (lo_c > hi_c) lo_c = hi_c = 0;  // empty: position 0 alone
  const int P = (int)(hi_c - lo_c) + 1;
  const int count = P + p.L - 1;  // samples the window's filters read

  // Stage the window's samples (zeros past them) and the template.
  const float* row = p.x + (long long)b * p.ldx + lo_c;
  for (int s = tid; s < p.staged; s += kThreads) {
    const bool valid = s < count;
    copy4(xs + sample_word(s), valid ? row + s : p.x, valid ? 4 : 0);
  }
  for (int c = tid; c < p.L / 2; c += kThreads) copy16(taps + c, p.tmpl + c);
  const float2 dc = p.dc[(long long)b * p.ld_dc];
  const bool finite = isfinite(dc.x) && isfinite(dc.y);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const float4* xs4 = smem4;
  const int steps = p.L / kStep;
  float best = -1.0f;
  int best_i = INT_MAX;
  for (int base = kPer * tid; base < P; base += kPer * kThreads) {
    const int u0 = base >> 2;
    float4 w[kWin];
#pragma unroll
    for (int j = 0; j < kWin; ++j) w[j] = xs4[slot(u0 + j)];
    float core = 0.0f;  // squares of samples kPer .. L - 1
#pragma unroll
    for (int j = kRun; j < kWin; ++j) {
      core = __fmaf_rn(w[j].x, w[j].x, core);
      core = __fmaf_rn(w[j].y, w[j].y, core);
      core = __fmaf_rn(w[j].z, w[j].z, core);
      core = __fmaf_rn(w[j].w, w[j].w, core);
    }
    float re[kPer], im[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      re[r] = 0.0f;
      im[r] = 0.0f;
    }
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      float tr[kStep], ti[kStep];
#pragma unroll
      for (int q = 0; q < kStep / 2; ++q) {
        const float4 t = taps[(kStep / 2) * s + q];
        tr[2 * q] = t.x;
        ti[2 * q] = t.y;
        tr[2 * q + 1] = t.z;
        ti[2 * q + 1] = t.w;
      }
      float v[kPer + kStep];
#pragma unroll
      for (int j = 0; j < kWin; ++j) {
        v[4 * j] = w[j].x;
        v[4 * j + 1] = w[j].y;
        v[4 * j + 2] = w[j].z;
        v[4 * j + 3] = w[j].w;
      }
#pragma unroll
      for (int q = 0; q < kStep; ++q) {
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          re[r] = __fmaf_rn(v[r + q], tr[q], re[r]);
          im[r] = __fmaf_rn(v[r + q], ti[q], im[r]);
        }
      }
      if (s + 1 < steps) {
#pragma unroll
        for (int j = 0; j < kWin - kNew; ++j) w[j] = w[j + kNew];
        // Samples kPer + kStep (s + 1) .. kPer + kStep (s + 2) - 1: in the
        // core up to L - 1, the tails after.
        const bool in_core = kPer + kStep * (s + 2) <= p.L;
#pragma unroll
        for (int j = kWin - kNew; j < kWin; ++j) {
          w[j] = xs4[slot(u0 + kNew * (s + 1) + j)];
          if (in_core) {
            core = __fmaf_rn(w[j].x, w[j].x, core);
            core = __fmaf_rn(w[j].y, w[j].y, core);
            core = __fmaf_rn(w[j].z, w[j].z, core);
            core = __fmaf_rn(w[j].w, w[j].w, core);
          }
        }
      }
    }
    // Now w holds samples L - kStep .. L + kPer - 1: the tails' squares of
    // samples L .. L + r - 1, and the heads' of samples r .. kPer - 1,
    // read again.
    float x[kPer + kStep];
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      x[4 * j] = w[j].x;
      x[4 * j + 1] = w[j].y;
      x[4 * j + 2] = w[j].z;
      x[4 * j + 3] = w[j].w;
    }
    float tail[kPer];
    tail[0] = 0.0f;
#pragma unroll
    for (int r = 1; r < kPer; ++r)
      tail[r] = __fmaf_rn(x[kStep + r - 1], x[kStep + r - 1], tail[r - 1]);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const float4 h = xs4[slot(u0 + j)];
      x[4 * j] = h.x;
      x[4 * j + 1] = h.y;
      x[4 * j + 2] = h.z;
      x[4 * j + 3] = h.w;
    }
    float head[kPer];
    head[kPer - 1] = x[kPer - 1] * x[kPer - 1];
#pragma unroll
    for (int r = kPer - 2; r >= 0; --r)
      head[r] = __fmaf_rn(x[r], x[r], head[r + 1]);
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int rel = base + r;
      if (rel < P) {
        const float energy = (head[r] + core) + tail[r];
        const float ee = energy * p.e_ref;
        const float mf =
            finite ? hypotf(re[r], im[r]) : __int_as_float(0x7fc00000);
        const float v = ee > 1e-12f ? mf / sqrtf(fmaxf(ee, 1e-30f)) : 0.0f;
        nmf[rel] = v;
        if (better(v, rel, best, best_i)) {
          best = v;
          best_i = rel;
        }
      }
    }
  }

  // The block's first largest.
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  if ((tid & (kWarp - 1)) == 0) {
    red_v[tid / kWarp] = best;
    red_i[tid / kWarp] = best_i;
  }
  __syncthreads();
  if (tid != 0) return;
  for (int w = 1; w < kWarps; ++w)
    if (better(red_v[w], red_i[w], best, best_i)) {
      best = red_v[w];
      best_i = red_i[w];
    }

  // The one-symbol rule: a comparable peak one symbol earlier, still in the
  // (unclipped) window, wins.
  long long lts = lo_c + best_i;
  float corr = best;
  const long long prev = lts - p.plen;
  if (prev >= lo) {
    long long pp = prev < 0 ? 0 : prev;
    if (pp > p.n_mf - 1) pp = p.n_mf - 1;
    int rel = (int)(pp - lo_c);
    rel = rel < 0 ? 0 : (rel > P - 1 ? P - 1 : rel);
    const float pc = nmf[rel];
    if (pc >= 0.85f * corr) {
      lts = pp;
      corr = pc;
    }
  }
  p.lts_start[b] = (int)lts;
  p.data_start[b] = (int)(lts + 2LL * p.plen);
  p.lts_corr[b] = corr;
}

// Checks the arguments and fills p; 0 or a CUDA error code.
int setup(Params* p, const void* x, long long ldx, int B, int T, int L,
          int plen) {
  if (B < 0 || T < 1 || L < kPer + kStep || L % 8 != 0 || L % kStep != 0 ||
      plen < 2 || L > T ||
      (B > 1 && ldx < T) || (uintptr_t)x % 4 != 0 ||
      shared_bytes(plen, L) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  p->x = (const float*)x;
  p->ldx = ldx;
  p->T = T;
  p->L = L;
  p->plen = plen;
  p->n_mf = T - L + 1;
  p->staged = staged_words(plen, L);
  p->positions = position_words(plen);
  return 0;
}

cudaError_t set_shared(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      lts_timing_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess || smem <= (size_t)kDefaultSharedMax) return err;
  return cudaFuncSetAttribute(lts_timing_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

// Launches the LTS timing of B lanes on `stream` (of the calling thread's
// current CUDA device); returns the CUDA error code of the launch (0 on
// success).  x: [B, T] float32 samples, row stride ldx; tmpl: [L] complex64,
// 16-byte aligned; sync_off: [B] int64; dc: the lanes' DC bins (complex64),
// ld_dc apart; lts_start, data_start: [B] int32; lts_corr: [B] float32.
int lts_timing_launch(const void* x, long long ldx, int B, int T,
                      const void* tmpl, int L, int plen, float e_ref,
                      const void* sync_off, const void* dc, long long ld_dc,
                      void* lts_start, void* data_start, void* lts_corr,
                      void* stream) {
  Params p;
  const int bad = setup(&p, x, ldx, B, T, L, plen);
  if (bad) return bad;
  if ((uintptr_t)tmpl % 16 != 0 || (uintptr_t)sync_off % 8 != 0 ||
      (uintptr_t)dc % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  p.e_ref = e_ref;
  p.tmpl = (const float4*)tmpl;
  p.sync_off = (const long long*)sync_off;
  p.dc = (const float2*)dc;
  p.ld_dc = ld_dc;
  p.lts_start = (int*)lts_start;
  p.data_start = (int*)data_start;
  p.lts_corr = (float*)lts_corr;
  const size_t smem = shared_bytes(plen, L);
  cudaError_t err = set_shared(smem);
  if (err != cudaSuccess) return (int)err;
  lts_timing_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// What lts_timing_launch would launch for these sizes on the current
// device: out[0] blocks, out[1] threads a block, out[2] dynamic shared
// bytes a block, out[3] blocks an SM can hold; returns the CUDA error code.
int lts_timing_plan(int B, int T, int L, int plen, long long* out) {
  Params p;
  const int bad = setup(&p, (const void*)0, T, B, T, L, plen);
  if (bad) return bad;
  const size_t smem = shared_bytes(plen, L);
  cudaError_t err = set_shared(smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lts_timing_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = B;
  out[1] = kThreads;
  out[2] = (long long)smem;
  out[3] = per_sm;
  return 0;
}

// The kernel's fixed sizes: positions a thread, threads a block.
int lts_timing_per_thread(void) { return kPer; }
int lts_timing_threads(void) { return kThreads; }

const char* lts_timing_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
