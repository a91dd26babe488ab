// Flooding min-sum LDPC decoder for Hopper (sm_90a): one block per
// codeword, its check rows sorted by degree.
//
// Replaces the TPU kernel projectultra_tpu/ops/pallas_ldpc.py::_kernel
// (called through decode_pallas), and computes exactly what the JAX decoder
// projectultra_tpu/ops/ldpc.py::decode computes with float32 messages:
//   * iteration 0 is stateless: v2c is the unclamped channel LLR;
//   * check update: two-minima min-sum with the first-occurrence argmin,
//     c2v = (sign * min_excl) * 0.75;
//   * v2c = clamp(llr_total[var] - c2v, -50, 50) from iteration 1 on;
//   * llr_total[v] = llr_in[v] + c2v[e0] + c2v[e1] + ..., added left to
//     right in ascending check order (the order _var_edge_table lists);
//   * syndrome: XOR of the hard bits of each check row;
//   * iters = 0-based iteration of convergence, else max_iters.
// Each block loops on its own codeword until it converges or reaches
// max_iters, which reproduces the JAX decoder's per-lane freezing without
// any host synchronisation.  No atomics, no tree reductions: every sum is
// one thread's serial loop in the order above.
//
// What bounds it on this card.  Not device memory: a codeword reads 2,592
// bytes of LLRs and writes 2,592 bytes, ~85 MB (~25 us at 3.35 TB/s) at
// B = 16,384.  Not float32 arithmetic either (~14 operations per edge and
// iteration).  The work is gathers through the Tanner graph in shared
// memory, in short dependent passes -- check rows, variable sums, syndrome
// -- between block barriers; every slot of a check row's unrolled loop is
// issued by the whole warp, whether or not its row has that edge.  A small
// batch is bound by its slowest codeword's chain of passes (a lane that
// never converges runs 50 iterations).
//
// The design, and what measuring it on an H100 decided:
//   * the check rows come sorted by degree, descending (the graph's
//     sorted_* tables; the variables' edge lists point at the sorted rows
//     and keep the ascending order of the original checks, so every sum
//     runs in the reference order).  The first row of a warp's 32 then has
//     the warp's largest degree, and the row pass is unrolled for 3, 5 or 7
//     slots by that warp-uniform degree instead of for the code's maximum:
//     the R1/2 code's rows have degrees 2 to 7 in no order, so an unsorted
//     warp issued 7 or 8 slots for rows of 5 edges on average;
//   * one block per codeword, its whole state in shared memory (llr_in,
//     llr_total and the d-major c2v array: 14 KB at R1/2, 19 KB at R1/4),
//     256 threads for large batches and 1,024 for small ones, where a wider
//     block cuts the slowest codeword's latency (cuda_ldpc.block_threads_for);
//   * a codeword whose channel decisions already satisfy every check
//     (every codeword at high SNR; known for free from the signs the first
//     check update reads) runs its first syndrome without the check update
//     of the next iteration, which a converged codeword discards; if it has
//     not converged it repeats the pass with the update (no second code
//     path, so the loop keeps its register allocation);
//   * the variable pass reads each variable's degree (var_deg) instead of
//     looping to a padding entry, and a warp whose variables have at most
//     5 edges issues all their loads before its serial adds;
//   * LLRs come in and llr_total goes out with 16-byte loads and stores.
// Tried and measured slower, so not kept: several codewords per block on
// named barriers, persistent blocks with a work queue and cp.async
// prefetch, int16 graph tables (staged per block, read through L1 in
// column-major order, or packed as 16-byte records), and channel LLRs in
// registers.  The fused loop is sensitive to its register allocation and to
// address arithmetic per edge: each of these took it from 32 registers
// (8 blocks of 256 threads per SM) to 40, or added instructions per edge.
//
// Floating point: the file is compiled with --fmad=false, so no multiply
// is contracted into an add; the additions run in the order written.
//
// bfloat16 messages (the JAX decoder's msg_dtype=bfloat16 fast mode, an
// XLA decode there, not a Pallas one): a second instantiation, MSG_BF16,
// rounds each v2c value (the channel LLR on the first pass, the clamped
// difference after it) to bfloat16, nearest-even, and reads it back as
// float32 where the row pass makes it, before the two-minima update --
// exactly where the JAX decoder stores its bf16 messages.  Its sign is
// tested on the rounded value (a tiny negative LLR can round to -0, which
// is not negative).  c2v stays float32 in shared memory: 0.75 times a
// bfloat16 magnitude needs up to 10 significant bits.  The float32
// instantiation compiles to the same code as before (if constexpr).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDegree = 7;    // check degree bound (the codes have D = 7)
constexpr float kScale = 0.75f;  // MIN_SUM_SCALE
constexpr float kClamp = 50.0f;  // V2C_CLAMP

// A v2c value as the decoder stores it: rounded to bfloat16 and read back
// when MSG_BF16, else unchanged.
template <bool MSG_BF16>
__device__ __forceinline__ float stored(float x) {
  if constexpr (MSG_BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// Check-row pass for row i, unrolled for K >= deg slots.  Reads the row's
// v2c (first: the channel LLRs; later: clamp(llr_total[var] - c2v)), writes
// the row's new c2v into msg (d-major: edge (i, d) at d*m + i) when
// `update` is set, and returns whether the row is unsatisfied: by the hard
// decision of llr_total when `check` is set, else (first) by the hard
// decision of the channel LLRs, whose signs the update reads anyway.
template <int K, bool MSG_BF16>
__device__ __forceinline__ bool row_pass(
    int i, int m, int D, const int* __restrict__ row_vars,
    const int* __restrict__ row_deg, const float* llr_in,
    const float* llr_tot, float* msg, bool first, bool check, bool update) {
  const int deg = row_deg[i];
  const int* rv = row_vars + (size_t)i * D;
  float v[kMaxDegree];  // (v[K] costs the loop 10 registers)
  int parity = 0;
#pragma unroll
  for (int d = 0; d < K; ++d) {
    if (d < deg) {
      const int var = rv[d];
      if (check) parity ^= (llr_tot[var] < 0.0f) ? 1 : 0;
      if (update) {
        if (first) {
          v[d] = stored<MSG_BF16>(llr_in[var]);
        } else {
          const float x = __fsub_rn(llr_tot[var], msg[d * m + i]);
          v[d] = stored<MSG_BF16>(fminf(fmaxf(x, -kClamp), kClamp));
        }
      }
    }
  }
  if (update) {
    const float inf = __int_as_float(0x7f800000);
    float min1 = inf, min2 = inf;
    int amin = 0, par = 0, negs = 0;
#pragma unroll
    for (int d = 0; d < K; ++d) {
      if (d < deg) {
        const float a = fabsf(v[d]);
        const int neg = v[d] < 0.0f ? 1 : 0;
        negs |= neg << d;
        par ^= neg;
        const bool is_new = a < min1;
        min2 = is_new ? min1 : (a < min2 ? a : min2);
        amin = is_new ? d : amin;
        min1 = is_new ? a : min1;
      }
    }
#pragma unroll
    for (int d = 0; d < K; ++d) {
      if (d < deg) {
        const float sign = ((par ^ (negs >> d)) & 1) ? -1.0f : 1.0f;
        const float min_excl = (amin == d) ? min2 : min1;
        msg[d * m + i] = __fmul_rn(__fmul_rn(sign, min_excl), kScale);
      }
    }
    if (first) parity = par;
  }
  return parity != 0;
}

// The row pass with K chosen by the warp's largest degree: rows are sorted
// by degree, descending, and a warp's rows are 32 consecutive ones starting
// at a multiple of 32, so the first of them has the largest degree.
template <bool MSG_BF16>
__device__ __forceinline__ bool row_pass_sorted(
    int i, int m, int D, const int* __restrict__ row_vars,
    const int* __restrict__ row_deg, const float* llr_in,
    const float* llr_tot, float* msg, bool first, bool check, bool update) {
  const int warp_deg = __ldg(row_deg + (i & ~31));
  if (warp_deg <= 3)
    return row_pass<3, MSG_BF16>(i, m, D, row_vars, row_deg, llr_in, llr_tot, msg,
                       first, check, update);
  if (warp_deg <= 5)
    return row_pass<5, MSG_BF16>(i, m, D, row_vars, row_deg, llr_in, llr_tot, msg,
                       first, check, update);
  return row_pass<kMaxDegree, MSG_BF16>(i, m, D, row_vars, row_deg, llr_in, llr_tot,
                              msg, first, check, update);
}

// llr_total[v] = llr_in[v] + c2v over v's deg edges, ascending check
// order.  A warp whose variables all have at most 5 edges (every warp of
// the R1/2 code; the degree-1 warps of the others) issues the edges'
// index and message loads together, then adds in order; wider warps loop.
__device__ __forceinline__ void var_pass(
    int n, int Dv, const int* __restrict__ var_edges,
    const int* __restrict__ var_deg, const float* llr_in, float* llr_tot,
    const float* msg) {
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const int* ve = var_edges + (size_t)v * Dv;
    const int deg = __ldg(var_deg + v);
    const unsigned warp_deg = __reduce_max_sync(__activemask(), deg);
    float s = llr_in[v];
    if (warp_deg <= 5) {
      int e[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) e[j] = j < deg ? ve[j] : 0;
      float x[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) x[j] = msg[e[j]];
#pragma unroll
      for (int j = 0; j < 5; ++j)
        if (j < deg) s = __fadd_rn(s, x[j]);
    } else {
      for (int j = 0; j < deg; ++j) s = __fadd_rn(s, msg[ve[j]]);
    }
    llr_tot[v] = s;
  }
}

template <int BLOCK, bool MSG_BF16>
__global__ void __launch_bounds__(BLOCK) ldpc_minsum_kernel(
    const float* __restrict__ llr, const int* __restrict__ row_vars,
    const int* __restrict__ row_deg, const int* __restrict__ var_edges,
    const int* __restrict__ var_deg, float* __restrict__ llr_out, uint8_t* __restrict__ ok_out,
    int* __restrict__ iters_out, int n, int m, int D, int Dv,
    int max_iters) {
  extern __shared__ __align__(16) float smem[];
  float* llr_in = smem;           // [n]
  float* llr_tot = smem + n;      // [n]
  float* msg = smem + 2 * n;      // [D * m], d-major: edge (i, d) at d*m + i
  const int b = blockIdx.x;

  const float4* src = reinterpret_cast<const float4*>(llr + (size_t)b * n);
  for (int c = threadIdx.x; c < n / 4; c += blockDim.x) {
    const float4 x = src[c];
    reinterpret_cast<float4*>(llr_in)[c] = x;
    reinterpret_cast<float4*>(llr_tot)[c] = x;
  }
  __syncthreads();

  bool ok = false;
  int iters = 0;
  if (max_iters > 0) {
    // Iteration 0; `clean`: the channel's own hard decisions satisfy every
    // check.
    int noisy = 0;
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      noisy |= row_pass_sorted<MSG_BF16>(i, m, D, row_vars, row_deg, llr_in, llr_tot,
                               msg, /*first=*/true, /*check=*/false,
                               /*update=*/true);
    bool clean = !__syncthreads_or(noisy);
    var_pass(n, Dv, var_edges, var_deg, llr_in, llr_tot, msg);
    __syncthreads();
    for (int it = 0;;) {
      // Syndrome of iteration `it`, fused with the check update of
      // iteration it + 1, which is discarded if the codeword converged --
      // so a clean codeword, which almost always converges here, skips it.
      const bool more = it + 1 < max_iters;
      int unsat = 0;
      for (int i = threadIdx.x; i < m; i += blockDim.x)
        unsat |= row_pass_sorted<MSG_BF16>(i, m, D, row_vars, row_deg, llr_in, llr_tot,
                                 msg, /*first=*/false, /*check=*/true,
                                 /*update=*/more && !clean);
      if (!__syncthreads_or(unsat)) {
        ok = true;
        iters = it;
        break;
      }
      if (!more) {
        iters = max_iters;
        break;
      }
      if (clean) {  // not converged after all: repeat the pass with its update
        clean = false;
        continue;
      }
      var_pass(n, Dv, var_edges, var_deg, llr_in, llr_tot, msg);
      __syncthreads();
      ++it;
    }
  }

  float4* dst = reinterpret_cast<float4*>(llr_out + (size_t)b * n);
  for (int c = threadIdx.x; c < n / 4; c += blockDim.x)
    dst[c] = reinterpret_cast<const float4*>(llr_tot)[c];
  if (threadIdx.x == 0) {
    ok_out[b] = ok ? 1 : 0;
    iters_out[b] = iters;
  }
}

using Kernel = void (*)(const float*, const int*, const int*, const int*,
                        const int*, float*, uint8_t*, int*, int, int, int, int, int);

template <bool MSG_BF16>
Kernel kernel_for(int threads) {
  switch (threads) {
    case 256: return ldpc_minsum_kernel<256, MSG_BF16>;
    case 1024: return ldpc_minsum_kernel<1024, MSG_BF16>;
    default: return nullptr;
  }
}

int launch(Kernel kernel, const float* llr, const int* row_vars,
           const int* row_deg, const int* var_edges, const int* var_deg,
           float* llr_out, uint8_t* ok, int* iters, int B, int n, int m,
           int D, int Dv, int max_iters, int threads, void* stream) {
  if (kernel == nullptr || D > kMaxDegree || D < 1 || n < 4 || n % 4 != 0 ||
      m < 1 || Dv < 1 || max_iters < 0 || B < 0 ||
      ((uintptr_t)llr | (uintptr_t)llr_out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * n + D * m) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // 19 KB at R1/4
  if (B == 0) return 0;
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      llr, row_vars, row_deg, var_edges, var_deg, llr_out, ok, iters, n, m, D, Dv,
      max_iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the decoder for B codewords on `stream`, which belongs to the
// calling thread's current CUDA device: one block of `threads` threads (256
// or 1,024) per codeword.  row_vars [m, D] and row_deg [m] list the check
// rows sorted by degree, descending; var_edges [n, Dv] indexes the d-major
// edges of those sorted rows, the first var_deg[v] of row v.  `llr` and `llr_out` must be 16-byte aligned
// and n a multiple of 4.  Returns the CUDA error code of the launch (0 on
// success).
int ldpc_minsum_decode(const float* llr, const int* row_vars,
                       const int* row_deg, const int* var_edges,
                       const int* var_deg, float* llr_out, uint8_t* ok, int* iters, int B, int n,
                       int m, int D, int Dv, int max_iters, int threads,
                       void* stream) {
  return launch(kernel_for<false>(threads), llr, row_vars, row_deg,
                var_edges, var_deg, llr_out, ok, iters, B, n, m, D, Dv,
                max_iters, threads, stream);
}

// The same decoder with bfloat16 v2c messages (arguments as above).
int ldpc_minsum_decode_bf16(const float* llr, const int* row_vars,
                            const int* row_deg, const int* var_edges,
                            const int* var_deg, float* llr_out, uint8_t* ok,
                            int* iters, int B, int n, int m, int D, int Dv,
                            int max_iters, int threads, void* stream) {
  return launch(kernel_for<true>(threads), llr, row_vars, row_deg,
                var_edges, var_deg, llr_out, ok, iters, B, n, m, D, Dv,
                max_iters, threads, stream);
}

const char* ldpc_minsum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
