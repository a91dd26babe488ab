// Flooding min-sum LDPC decoder for Hopper (sm_90a), one thread block per
// codeword.
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
// any host synchronisation.
//
// The TPU kernel's one-hot gather/scatter matmuls and its 128-lane,
// m_pad-row layout were workarounds for the matrix unit; here the gathers
// are plain indexed loads from shared memory.
//
// What bounds it on this card: not device memory (each codeword reads
// 2.6 KB of LLRs once and writes its results once) but latency inside a
// block: every iteration is three dependent passes (check rows, variable
// sums, syndrome) separated by block barriers, with short serial loops of
// at most 7 (check) and Dv (variable) steps per thread.  The design keeps
// the whole decoder state of a codeword in shared memory (llr_in, llr_total
// and one edge-message array: 14 KB at R1/2, 19 KB at R1/4), so several
// blocks share an SM and hide each other's barrier stalls; v2c never goes
// to memory, because the thread that owns a check row computes it in
// registers right before its check update.  Several codewords per block,
// bf16 messages and warp-level check updates are left for later work.
//
// Floating point: the file is compiled with --fmad=false, so no multiply
// is contracted into an add; the additions run in the order written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDegree = 8;    // check degree bound (the codes have D = 7)
constexpr int kThreads = 256;
constexpr float kScale = 0.75f;  // MIN_SUM_SCALE
constexpr float kClamp = 50.0f;  // V2C_CLAMP

// Check-row pass for row i.  Reads the row's v2c (iteration 0: the channel
// LLRs; later: clamp(llr_total - c2v)), writes the new c2v into msg, and
// returns whether the hard decision of llr_total violates the row (only
// meaningful when `check` is set).
__device__ __forceinline__ bool row_pass(
    int i, int m, int D, const int* __restrict__ row_vars,
    const int* __restrict__ row_deg, const float* llr_in,
    const float* llr_tot, float* msg, bool first, bool check, bool update) {
  const int deg = row_deg[i];
  const int* rv = row_vars + (size_t)i * D;
  float v[kMaxDegree];
  int parity = 0;
#pragma unroll
  for (int d = 0; d < kMaxDegree; ++d) {
    if (d < deg) {
      const int var = rv[d];
      if (check) parity ^= (llr_tot[var] < 0.0f) ? 1 : 0;
      if (update) {
        if (first) {
          v[d] = llr_in[var];
        } else {
          const float x = __fsub_rn(llr_tot[var], msg[d * m + i]);
          v[d] = fminf(fmaxf(x, -kClamp), kClamp);
        }
      }
    }
  }
  if (update) {
    const float inf = __int_as_float(0x7f800000);
    float min1 = inf, min2 = inf;
    int amin = 0, par = 0, negs = 0;
#pragma unroll
    for (int d = 0; d < kMaxDegree; ++d) {
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
    for (int d = 0; d < kMaxDegree; ++d) {
      if (d < deg) {
        const float sign = ((par ^ (negs >> d)) & 1) ? -1.0f : 1.0f;
        const float min_excl = (amin == d) ? min2 : min1;
        msg[d * m + i] = __fmul_rn(__fmul_rn(sign, min_excl), kScale);
      }
    }
  }
  return parity != 0;
}

// llr_total[v] = llr_in[v] + c2v over v's edges, ascending check order.
__device__ __forceinline__ void var_pass(
    int n, int Dv, int E, const int* __restrict__ var_edges,
    const float* llr_in, float* llr_tot, const float* msg) {
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const int* ve = var_edges + (size_t)v * Dv;
    float s = llr_in[v];
    for (int j = 0; j < Dv; ++j) {
      const int e = ve[j];
      if (e >= E) break;  // padding entries point past the last edge
      s = __fadd_rn(s, msg[e]);
    }
    llr_tot[v] = s;
  }
}

__global__ void __launch_bounds__(kThreads) ldpc_minsum_kernel(
    const float* __restrict__ llr, const int* __restrict__ row_vars,
    const int* __restrict__ row_deg, const int* __restrict__ var_edges,
    float* __restrict__ llr_out, uint8_t* __restrict__ ok_out,
    int* __restrict__ iters_out, int n, int m, int D, int Dv,
    int max_iters) {
  extern __shared__ float smem[];
  float* llr_in = smem;           // [n]
  float* llr_tot = smem + n;      // [n]
  float* msg = smem + 2 * n;      // [D * m], d-major: edge (i, d) at d*m + i
  const int b = blockIdx.x;
  const int E = D * m;
  const float* src = llr + (size_t)b * n;

  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    llr_in[v] = src[v];
    llr_tot[v] = src[v];
  }
  __syncthreads();

  bool ok = false;
  int iters = 0;
  if (max_iters > 0) {
    // Iteration 0.
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      row_pass(i, m, D, row_vars, row_deg, llr_in, llr_tot, msg,
               /*first=*/true, /*check=*/false, /*update=*/true);
    __syncthreads();
    var_pass(n, Dv, E, var_edges, llr_in, llr_tot, msg);
    __syncthreads();
    for (int it = 0;; ++it) {
      // Syndrome of iteration `it`, fused with the check update of
      // iteration it + 1 (which is discarded if the codeword converged).
      const bool more = it + 1 < max_iters;
      int unsat = 0;
      for (int i = threadIdx.x; i < m; i += blockDim.x)
        unsat |= row_pass(i, m, D, row_vars, row_deg, llr_in, llr_tot, msg,
                          /*first=*/false, /*check=*/true, /*update=*/more);
      if (!__syncthreads_or(unsat)) {
        ok = true;
        iters = it;
        break;
      }
      if (!more) {
        iters = max_iters;
        break;
      }
      var_pass(n, Dv, E, var_edges, llr_in, llr_tot, msg);
      __syncthreads();
    }
  }

  float* dst = llr_out + (size_t)b * n;
  for (int v = threadIdx.x; v < n; v += blockDim.x) dst[v] = llr_tot[v];
  if (threadIdx.x == 0) {
    ok_out[b] = ok ? 1 : 0;
    iters_out[b] = iters;
  }
}

}  // namespace

extern "C" {

// Launches the decoder for B codewords on `stream`, which belongs to the
// calling thread's current CUDA device; returns the CUDA error code of the
// launch (0 on success).
int ldpc_minsum_decode(const float* llr, const int* row_vars,
                       const int* row_deg, const int* var_edges,
                       float* llr_out, uint8_t* ok, int* iters, int B, int n,
                       int m, int D, int Dv, int max_iters, void* stream) {
  if (D > kMaxDegree || D < 1 || n < 1 || m < 1 || Dv < 1 ||
      max_iters < 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = (size_t)(2 * n + D * m) * sizeof(float);
  ldpc_minsum_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      llr, row_vars, row_deg, var_edges, llr_out, ok, iters, n, m, D, Dv,
      max_iters);
  return (int)cudaGetLastError();
}

const char* ldpc_minsum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
