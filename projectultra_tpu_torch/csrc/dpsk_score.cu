// DPSK preamble search's differential pattern score for Hopper (sm_90a):
// every differential and every symbol energy computed once per (row,
// sample) into shared memory, then each offset's 38 signed terms and 39
// energies summed in registers, eight offsets a thread.
//
// Replaces the inner score of find_preamble: in the JAX package one XLA
// fusion over a gathered [B, O, 39] grid (projectultra_tpu/psk/dpsk.py:
// 305-317, computeDifferentialScore of dpsk.hpp:487-546), in the port's
// plain version a loop of 38 steps of about a dozen eager passes over
// [B, O] complex arrays (ops/dpsk_score.py::dpsk_score_plain).  For row b
// and offset o < O, with
// c_j = corr[b, o + j*L] (j < 39):
//   dn_j  = d / |d| where |d| > 1e-10, else 0, for d = c_j * conj(c_{j-1})
//   score = |sum_{j=1..38} expected[j-1] * dn_j| / 38
//           where sum_{j=0..38} |c_j|^2 >= threshold, else 0.
//
// The plain version's arithmetic, term for term.  dn_j of offset o is a
// function of the two samples m = o + (j-1)*L and m + L alone, so it is one
// value D[m] whatever the offset that uses it; likewise E[m] = |c(m)|^2.  The
// kernel computes D[m] and E[m] as PyTorch's CUDA operators do: the complex
// product (a*c - b*d, a*d + b*c) with the two fused multiply-adds that
// PyTorch's build makes of it, fma(a, c, -(b*d)) and fma(a, d, b*c) (of the
// four ways to fuse it, and none, only this one gave scores bit-equal to
// the plain version's at both DPSK presets: 0 of 30,670,848 differ at
// `medium`, PyTorch 2.11 with CUDA 12.8; unfused, 43% of them differed by
// up to 3.6e-7 and one lane's CFO estimate moved); |.| as hypotf
// (thrust::abs); the division by the real magnitude as c10::complex's
// division by (mag, 0), whose ratio d/c is 0 here, so ((re + im*0) * s,
// (im - re*0) * s) with s = 1/mag correctly rounded (the products with 0
// keep an infinite part's NaN); |c|^2 as hypotf squared; the final / 38 as
// a product with the float reciprocal (PyTorch divides a CUDA tensor by a
// host scalar so).  Each offset's sums then add the same values in the
// plain version's order: the signed differentials from j = 1 upward
// starting at 0, the energies from j = 0 upward.  A +-1 sign makes
// fma(s, D, acc) the rounded sum acc + (+-D), as the plain version's
// complex product by (s, 0) then sum gives.  Built with --fmad=false, so
// nothing else fuses.  Another PyTorch build may fuse its product
// otherwise; the comparisons therefore state a tolerance.  Non-finite
// samples: a NaN differential magnitude fails the > 1e-10 test (dn = 0),
// an infinite one makes dn NaN, and a NaN or +inf energy decides the
// threshold as in the plain version, so non-finite scores appear at the
// same offsets and of the same kind.
//
// What bounds it on this card.  Device memory: it reads the O + 38*L
// samples of each row once (8 B each) and writes O scores (4 B): at DPSK
// `medium` (B = 256, L = 768, O = 119,808) 305 MB + 123 MB, 0.128 ms at
// 3.35 TB/s.  Its float work (per offset 76 signed adds and 38 energy adds,
// per sample a complex product, two hypotf and a reciprocal) is about half
// that at the float32 rate, but the adds cannot use fused multiply-adds of
// two products, so the add pipe comes close behind the bytes.
//
// The design (a simple kernel first; PERF.md has its measured time):
//   * Offsets o = r + k*L are tiled by residue r and symbol index k: a block
//     takes 32 consecutive residues of one row (a warp's lanes, so every
//     load and store is 32 consecutive elements) and up to kMaxTile
//     consecutive k.  Its offsets need the samples r + i*L for
//     i < tile + 38 only: one column of the row every L samples, which the
//     block's rows of shared memory hold as D and E for its 32 residues.
//     At the DPSK presets K = O/L = 156, so one tile covers all of k and
//     the block computes each D and E of its residues once; a second tile
//     recomputes the 38-symbol halo.  Small batches (the engine's B = 1
//     views) take smaller tiles so that the grid fills the card.
//   * Phase 1: each warp loads a contiguous run of rows of the block's
//     columns into registers (all loads issued before any use), computes
//     their D and E and stores them to shared memory ([row][lane], float2
//     and float: conflict-free).
//   * Phase 2: each thread sums kChunk = 8 consecutive k of its residue at
//     once: it reads the 8 + 37 differentials and 8 + 38 energies of that
//     run once each and adds each into every one of the 8 sums that holds
//     it, fully unrolled, so the sign of every term is a compile-time index
//     into the kernel's parameter block and each term costs one fma.  A
//     warp-chunk is 32 residues x 8 offsets; warps walk the tile's chunks.
//   * Shared memory: (round_up(tile, 8) + 38) rows x 32 lanes x 12 B,
//     76,032 B at a full tile: three blocks of 8 warps an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPairs = 38;             // differentials an offset sums
constexpr int kLanes = 32;             // residues a block covers
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kChunk = 8;              // offsets a thread sums at once
constexpr int kMaxTile = 156;          // symbol indices k a block covers
constexpr int kMaxRows = (kMaxTile + kChunk - 1) / kChunk * kChunk + kPairs;
constexpr int kRowsPerWarp = (kMaxRows + kWarps - 1) / kWarps;
constexpr float kMinMagnitude = 1e-10f;  // the plain version's |d| > 1e-10

struct Signs {
  float s[kPairs];
};

struct Params {
  const float2* corr;   // [B, n_corr] complex64 as (re, im), row stride lda
  long long lda;
  long long n_corr;
  int L;                // samples a symbol
  int O;                // offsets a row
  int K;                // ceil(O / L): symbol indices k of o = r + k*L
  int tile;             // k a block covers
  int tiles;            // tiles a row (ceil(K / tile))
  float threshold;      // energy threshold (min_energy * n_sym as float)
  float inv_pairs;      // float(1) / float(38)
  float* score;         // [B, O] float32, contiguous
  Signs signs;
};

__host__ __device__ constexpr int rows_for(int tile) {
  return (tile + kChunk - 1) / kChunk * kChunk + kPairs;
}

size_t shared_bytes(int tile) {
  return (size_t)rows_for(tile) * kLanes * (sizeof(float2) + sizeof(float));
}

// dn for the differential cur * conj(prev), as PyTorch's CUDA operators
// compute where(|d| > 1e-10, d / clamp(|d|, 1e-30), 0).
__device__ __forceinline__ float2 differential(float2 cur, float2 prev) {
  const float c = prev.x, d = -prev.y;
  // c10::complex's (a*c - b*d, a*d + b*c) as PyTorch's CUDA build
  // contracts it (measured bit-equal; see the note above).
  const float re = __fmaf_rn(cur.x, c, -(cur.y * d));
  const float im = __fmaf_rn(cur.x, d, cur.y * c);
  const float mag = hypotf(re, im);
  if (!(mag > kMinMagnitude)) return make_float2(0.0f, 0.0f);
  // c10::complex (re, im) / (mag, 0) with mag > 1e-10 (the clamp at 1e-30
  // leaves it): ratio 0 / mag = 0, scale 1 / (mag + 0 * 0) = 1 / mag.
  const float ratio = 0.0f;
  const float scale = 1.0f / mag;
  return make_float2((re + im * ratio) * scale, (im - re * ratio) * scale);
}

__global__ void __launch_bounds__(kThreads, 3)
dpsk_score_kernel(const Params p) {
  extern __shared__ float4 smem[];
  const int rows = rows_for(p.tile);
  float2* sD = reinterpret_cast<float2*>(smem);          // [rows][32]
  float* sE = reinterpret_cast<float*>(sD + rows * kLanes);  // [rows][32]

  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int t = blockIdx.x % p.tiles;
  const int r = (blockIdx.x / p.tiles) * kLanes + lane;  // residue
  const int b = blockIdx.y;
  const int k0 = t * p.tile;
  const bool live = r < p.L;
  const float2* row = p.corr + (long long)b * p.lda;

  // Phase 1: D[i] and E[i] of sample r + (k0 + i) * L for i < rows (zeros
  // past the row; those rows feed only offsets >= O).
  const int per_warp = (rows + kWarps - 1) / kWarps;
  const int i0 = warp * per_warp;
  float2 c[kRowsPerWarp + 1];
#pragma unroll
  for (int u = 0; u <= kRowsPerWarp; ++u) {
    const int i = i0 + u;
    const long long m = (long long)r + (long long)(k0 + i) * p.L;
    c[u] = make_float2(0.0f, 0.0f);
    if (live && u <= per_warp && i < rows && m < p.n_corr) c[u] = __ldg(row + m);
  }
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
    const int i = i0 + u;
    if (u < per_warp && i < rows) {
      const float h = hypotf(c[u].x, c[u].y);
      sE[i * kLanes + lane] = h * h;
      if (i + 1 < rows) sD[i * kLanes + lane] = differential(c[u + 1], c[u]);
    }
  }
  __syncthreads();
  if (!live) return;

  // Phase 2: offsets k0 + q .. k0 + q + 7 of residue r, each summing its
  // terms in the plain version's order.
  const int kb = min(p.tile, p.K - k0);
  float* out = p.score + (long long)b * p.O;
  for (int q = warp * kChunk; q < kb; q += kWarps * kChunk) {
    float ax[kChunk], ay[kChunk], en[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      ax[k] = 0.0f;
      ay[k] = 0.0f;
      en[k] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kChunk + kPairs; ++i) {
      const float e = sE[(q + i) * kLanes + lane];
      float2 d = make_float2(0.0f, 0.0f);
      if (i < kChunk + kPairs - 1) d = sD[(q + i) * kLanes + lane];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int j = i - k;  // term j + 1 of offset k (differentials)
        if (j >= 0 && j < kPairs) {
          ax[k] = __fmaf_rn(p.signs.s[j], d.x, ax[k]);
          ay[k] = __fmaf_rn(p.signs.s[j], d.y, ay[k]);
        }
        if (j == 0) {
          en[k] = e;
        } else if (j > 0 && j <= kPairs) {
          en[k] = __fadd_rn(en[k], e);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const long long o = (long long)r + (long long)(k0 + q + k) * p.L;
      if (q + k < kb && o < p.O)
        out[o] = en[k] >= p.threshold ? hypotf(ax[k], ay[k]) * p.inv_pairs
                                      : 0.0f;
    }
  }
}

// Checks the arguments and fills p; 0 or a CUDA error code.
int setup(Params* p, const void* corr, long long lda, int B, long long n_corr,
          int L, int O, int tile, const float* signs, float threshold,
          float inv_pairs, void* score) {
  if (B < 0 || B > 65535 || L < 1 || O < 0 || tile < 1 || tile > kMaxTile ||
      (O > 0 && (long long)O - 1 + (long long)kPairs * L >= n_corr) ||
      lda < n_corr || (uintptr_t)corr % 8 != 0)
    return (int)cudaErrorInvalidValue;
  p->corr = (const float2*)corr;
  p->lda = lda;
  p->n_corr = n_corr;
  p->L = L;
  p->O = O;
  p->K = (int)(((long long)O + L - 1) / L);
  p->tile = tile;
  p->tiles = (p->K + tile - 1) / tile;
  p->threshold = threshold;
  p->inv_pairs = inv_pairs;
  p->score = (float*)score;
  if (signs != nullptr)
    for (int j = 0; j < kPairs; ++j) p->signs.s[j] = signs[j];
  const long long blocks = (long long)p->tiles * ((L + kLanes - 1) / kLanes);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return 0;
}

dim3 grid_of(const Params& p, int B) {
  return dim3((unsigned)(p.tiles * ((p.L + kLanes - 1) / kLanes)), (unsigned)B);
}

cudaError_t prepare(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      dpsk_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(dpsk_score_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

// Launches the score for B rows on `stream` (of the calling thread's
// current CUDA device); returns the CUDA error code of the launch (0 on
// success).  `signs` is a host array of the 38 expected signs (+-1), copied
// into the kernel's parameters.  The caller guarantees that corr holds
// O - 1 + 38 * L < n_corr samples a row and that score is [B, O]
// contiguous.
int dpsk_score_launch(const void* corr, long long lda, int B,
                      long long n_corr, int L, int O, int tile,
                      const float* signs, float threshold, float inv_pairs,
                      void* score, void* stream) {
  Params p;
  const int bad = setup(&p, corr, lda, B, n_corr, L, O, tile, signs,
                        threshold, inv_pairs, score);
  if (bad) return bad;
  if (B == 0 || O == 0) return 0;
  const size_t smem = shared_bytes(tile);
  const cudaError_t err = prepare(smem);
  if (err != cudaSuccess) return (int)err;
  dpsk_score_kernel<<<grid_of(p, B), kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// What dpsk_score_launch would launch for these sizes on the current
// device: out[0] blocks, out[1] dynamic shared bytes a block, out[2] blocks
// an SM can hold, out[3] tiles a row; returns the CUDA error code.
int dpsk_score_plan(int B, long long n_corr, int L, int O, int tile,
                    long long* out) {
  Params p;
  const int bad = setup(&p, (const void*)0, n_corr, B, n_corr, L, O, tile,
                        nullptr, 0.0f, 0.0f, nullptr);
  if (bad) return bad;
  const size_t smem = shared_bytes(tile);
  cudaError_t err = prepare(smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dpsk_score_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 g = grid_of(p, B);
  out[0] = (long long)g.x * g.y;
  out[1] = (long long)smem;
  out[2] = per_sm;
  out[3] = p.tiles;
  return 0;
}

// The kernel's fixed sizes: differentials an offset sums, largest tile.
int dpsk_score_pairs(void) { return kPairs; }
int dpsk_score_max_tile(void) { return kMaxTile; }

const char* dpsk_score_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
