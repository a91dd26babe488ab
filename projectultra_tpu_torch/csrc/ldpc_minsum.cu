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
//     llr_total and the edge messages: 14 KB at R1/2, 19 KB at R1/4 with
//     float32 messages), 256 threads for large batches and 1,024 for small
//     ones, where a wider block cuts the slowest codeword's latency
//     (cuda_ldpc.block_threads_for);
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
// NaN and infinity go through as the JAX decoder computes them op by op
// (jnp.clip, jnp.minimum): the v2c clamp and min2 keep a NaN (PTX
// min.NaN/max.NaN, where fminf/fmaxf would drop it), +-inf clamps to
// +-50, and a NaN is neither negative nor a new min1 (its comparisons are
// false).  A NaN reaches the decoder as an LLR (the demappers' clip_llr
// passes one through) or is made where +inf and -inf meet in a sum.
// A row's slots beyond its degree hold +inf, which the two-minima update
// never takes (JAX masks them the same way), so that loop runs all K
// slots without a branch: the min.NaN/max.NaN asm cannot be predicated,
// and behind a `d < deg` test it costs branches and moves (2% at 1,024
// threads on an H100; branch-free, every shape is faster than with
// fminf/fmaxf).  __launch_bounds__ asks for 2,048 threads per SM (8
// blocks of 256, 2 of 1,024), which holds both instantiations at 32
// registers: without it the branch-free float32 loop took 39 at 256.
//
// bfloat16 messages (the JAX decoder's msg_dtype=bfloat16 fast mode, an
// XLA decode there, not a Pallas one): the RECORDS instantiation.  Each v2c
// value (the channel LLR on the first pass, the clamped difference after
// it) is rounded to bfloat16, nearest-even, where the row pass makes it,
// before the two-minima update -- exactly where the JAX decoder stores its
// bf16 messages; its sign is tested on the rounded value (a tiny negative
// LLR can round to -0, which is not negative).  A row's c2v values are
// then fixed by its two minima, the slot of the first and the D signs, so
// instead of D float32 c2v values the row keeps one 8-byte record (below):
// 2n*4 + 8m bytes of shared memory a codeword instead of (2n + Dm)*4
// (R1/2: 7,776 instead of 14,256), and the row pass makes one record load
// and one record store per row instead of deg loads and deg stores.  The
// passes rebuild each c2v from the record where they read it; min1 and min2
// are magnitudes of bf16 values, and 0.75 times a bf16 magnitude is exact
// in float32 (10 significant bits, subnormals and inf included), so every
// rebuilt c2v is bit for bit the float32 value the float32-state design
// stored, and bits, ok flags and iterations stay those of the plain bf16
// decoder.  The variable pass reads a (row << 3 | slot) table
// (LDPCGraph.sorted_var_slots), whose entry is the record's byte offset
// plus its slot, so no division by m is left on an edge.
// What bounds it is what bounds the float32 design, with fewer shared
// stores and more integer work per edge (a rebuild is a shift, a select
// and a multiply).  What measuring it on an H100 decided: the record kernel
// has to stay at 32 registers, as the float32 one does.  The float32
// design's five-deep preload of the variable pass, holding 8-byte records,
// took it to 39 (6 blocks of 256 per SM; 32 with spills at 1,024 threads)
// and made it slower than the float32-state bf16 kernel at the main path
// and on the small batches; so a warp of degree-1 variables takes its one
// edge directly and the others loop, and the c2v sign goes into the 0.75
// factor (one dependent operation less per edge).  Tried and measured
// slower, so not kept: __launch_bounds__ minimum blocks on the records
// design before its two-minima loop was branch-free (32 registers, but
// slower B = 1 and stuck-lane batches at 1,024 threads), the preload split
// 3 + 2 (32 registers, but slower on the waterfall and at B = 1 R1/4), the
// loop in batches of 2 or 3 loads (38-40 registers), the loop without
// unrolling, the row pass rebuilding per slot from the record word instead
// of its two scaled minima, and the LLR rows copied in and out with one
// TMA bulk copy (cp.async.bulk and an mbarrier) instead of 16-byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDegree = 7;    // check degree bound (the codes have D = 7)
constexpr float kScale = 0.75f;  // MIN_SUM_SCALE
constexpr float kClamp = 50.0f;  // V2C_CLAMP

// min and max that return NaN when either operand is NaN (the canonical
// NaN, 0x7fffffff), as jnp.minimum/torch.minimum do; one instruction each,
// as fminf/fmaxf are.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// v2c = clip(x, -50, 50) as jnp.clip: NaN stays NaN, +-inf -> +-50, -0
// stays -0.
__device__ __forceinline__ float clamp_v2c(float x) {
  return min_nan(max_nan(x, -kClamp), kClamp);
}

// ---------------------------------------------------------------------------
// float32 messages: D c2v values per check row, d-major
// ---------------------------------------------------------------------------

// Check-row pass for row i, unrolled for K >= deg slots.  Reads the row's
// v2c (first: the channel LLRs; later: clamp(llr_total[var] - c2v); +inf
// on the slots beyond deg, which the two-minima update ignores), writes
// the row's new c2v into msg (d-major: edge (i, d) at d*m + i) when
// `update` is set, and returns whether the row is unsatisfied: by the hard
// decision of llr_total when `check` is set, else (first) by the hard
// decision of the channel LLRs, whose signs the update reads anyway.
template <int K>
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
          v[d] = llr_in[var];
        } else {
          v[d] = clamp_v2c(__fsub_rn(llr_tot[var], msg[d * m + i]));
        }
      }
    } else {
      v[d] = __int_as_float(0x7f800000);
    }
  }
  if (update) {
    const float inf = __int_as_float(0x7f800000);
    float min1 = inf, min2 = inf;
    int amin = 0, par = 0, negs = 0;
#pragma unroll
    for (int d = 0; d < K; ++d) {
      const float a = fabsf(v[d]);
      const int neg = v[d] < 0.0f ? 1 : 0;
      negs |= neg << d;
      par ^= neg;
      const bool is_new = a < min1;
      min2 = is_new ? min1 : min_nan(min2, a);  // NaN a: min2 NaN
      amin = is_new ? d : amin;
      min1 = is_new ? a : min1;
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

// ---------------------------------------------------------------------------
// bfloat16 messages: one record per check row
// ---------------------------------------------------------------------------
//
// A row's record (uint2, 8 bytes):
//   x = min1's bfloat16 bits << 16 | min2's bfloat16 bits: the row's two
//       smallest |v2c|, each a bf16 magnitude;
//   y = bit 31 - d set where the row's c2v on slot d is negative (d < deg;
//       clear beyond), and bit 24 - amin set, amin the slot of min1 (its
//       first occurrence).
// The row's c2v on slot d is (sign_d * (d == amin ? min2 : min1)) * 0.75;
// y << d holds slot d's sign in bit 31 and d == amin in bit 24, so the
// slot is spent in one shift.
// NaN: min1 is never NaN (a NaN is never below it), min2 may be.  Every
// |v2c| the row pass compares is a bf16 value read back (low 16 bits
// zero; a NaN one is __float2bfloat16_rn's canonical 0x7fff), and a NaN
// min2 comes from min.NaN as the canonical 0x7fffffff; either way its top
// 16 bits are a bf16 NaN (0x7fff), which the passes rebuild into a NaN
// c2v (NaN * +-0.75).

// A v2c value rounded to bfloat16, nearest-even, and read back.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

constexpr unsigned kSignBit = 0x80000000u;
constexpr unsigned kAminBit = 0x01000000u;

// The c2v of record r on slot d, bit for bit (sign * min_excl) * 0.75:
// multiplying by -1 is exact, so min_excl * (sign * 0.75) rounds alike.
__device__ __forceinline__ float rebuild(uint2 r, int d) {
  const unsigned t = r.y << d;
  const unsigned mag = (t & kAminBit) ? (r.x << 16) : (r.x & 0xffff0000u);
  return __fmul_rn(__uint_as_float(mag),
                   __uint_as_float(__float_as_uint(kScale) | (t & kSignBit)));
}

// The check-row pass of the float32 design (arguments alike) on records:
// the old c2v come from the row's record, read before it is overwritten
// (its two scaled minima once, then a select and a sign per slot).
template <int K>
__device__ __forceinline__ bool row_pass_records(
    int i, int D, const int* __restrict__ row_vars,
    const int* __restrict__ row_deg, const float* llr_in,
    const float* llr_tot, uint2* rec, bool first, bool check, bool update) {
  const int deg = row_deg[i];
  const int* rv = row_vars + (size_t)i * D;
  float c1 = 0.0f, c2 = 0.0f;  // min1 * 0.75 and min2 * 0.75 of the record
  unsigned meta = 0;
  if (update && !first) {
    const uint2 r = rec[i];
    c1 = __fmul_rn(__uint_as_float(r.x & 0xffff0000u), kScale);
    c2 = __fmul_rn(__uint_as_float(r.x << 16), kScale);
    meta = r.y;
  }
  float v[kMaxDegree];
  int parity = 0;
#pragma unroll
  for (int d = 0; d < K; ++d) {
    if (d < deg) {
      const int var = rv[d];
      if (check) parity ^= (llr_tot[var] < 0.0f) ? 1 : 0;
      if (update) {
        if (first) {
          v[d] = bf16_round(llr_in[var]);
        } else {
          const unsigned t = meta << d;
          const float c = __uint_as_float(
              __float_as_uint((t & kAminBit) ? c2 : c1) | (t & kSignBit));
          v[d] = bf16_round(clamp_v2c(__fsub_rn(llr_tot[var], c)));
        }
      }
    } else {
      v[d] = __int_as_float(0x7f800000);
    }
  }
  if (update) {
    const float inf = __int_as_float(0x7f800000);
    float min1 = inf, min2 = inf;
    int amin = 0, par = 0;
    unsigned negs = 0;
#pragma unroll
    for (int d = 0; d < K; ++d) {
      const float a = fabsf(v[d]);
      const int neg = v[d] < 0.0f ? 1 : 0;
      negs |= (unsigned)neg << (31 - d);
      par ^= neg;
      const bool is_new = a < min1;
      min2 = is_new ? min1 : min_nan(min2, a);  // NaN a: min2 NaN
      amin = is_new ? d : amin;
      min1 = is_new ? a : min1;
    }
    // c2v's sign on slot d is par ^ neg_d: flip the row's deg sign bits.
    // min2 >> 16 is its bf16 bits (a NaN min2: 0x7fff, see above).
    const unsigned flip = par ? ~(0xffffffffu >> deg) : 0u;
    rec[i] = make_uint2(__float_as_uint(min1) | (__float_as_uint(min2) >> 16),
                        (negs ^ flip) | (kAminBit >> amin));
    if (first) parity = par;
  }
  return parity != 0;
}

// The variable pass of the float32 design on records: var_slots [n, Dv]
// holds (sorted row << 3 | slot), the record's byte offset plus its slot.
// A warp whose variables have at most one edge (the parity bits: half the
// variables of every code) takes it without the loop; the others loop.
// (The float32 design's five-deep preload of records took the kernel to 39
// registers and lost.)
__device__ __forceinline__ void var_pass_records(
    int n, int Dv, const int* __restrict__ var_slots,
    const int* __restrict__ var_deg, const float* llr_in, float* llr_tot,
    const uint2* rec) {
  const char* base = reinterpret_cast<const char*>(rec);
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const int* ve = var_slots + (size_t)v * Dv;
    const int deg = __ldg(var_deg + v);
    const unsigned warp_deg = __reduce_max_sync(__activemask(), deg);
    float s = llr_in[v];
    if (warp_deg <= 1) {
      const int e = deg > 0 ? ve[0] : 0;
      const uint2 r = *reinterpret_cast<const uint2*>(base + (e & ~7));
      if (deg > 0) s = __fadd_rn(s, rebuild(r, e & 7));
    } else {
      for (int j = 0; j < deg; ++j) {
        const int e = ve[j];
        s = __fadd_rn(s, rebuild(*reinterpret_cast<const uint2*>(
                                     base + (e & ~7)), e & 7));
      }
    }
    llr_tot[v] = s;
  }
}

// ---------------------------------------------------------------------------
// The decoder
// ---------------------------------------------------------------------------

template <int K, bool RECORDS>
__device__ __forceinline__ bool row_pass_k(
    int i, int m, int D, const int* __restrict__ row_vars,
    const int* __restrict__ row_deg, const float* llr_in,
    const float* llr_tot, float* msg, bool first, bool check, bool update) {
  if constexpr (RECORDS) {
    return row_pass_records<K>(i, D, row_vars, row_deg, llr_in, llr_tot,
                               reinterpret_cast<uint2*>(msg), first, check,
                               update);
  } else {
    return row_pass<K>(i, m, D, row_vars, row_deg, llr_in, llr_tot, msg,
                       first, check, update);
  }
}

// The row pass with K chosen by the warp's largest degree: rows are sorted
// by degree, descending, and a warp's rows are 32 consecutive ones starting
// at a multiple of 32, so the first of them has the largest degree.
template <bool RECORDS>
__device__ __forceinline__ bool row_pass_sorted(
    int i, int m, int D, const int* __restrict__ row_vars,
    const int* __restrict__ row_deg, const float* llr_in,
    const float* llr_tot, float* msg, bool first, bool check, bool update) {
  const int warp_deg = __ldg(row_deg + (i & ~31));
  if (warp_deg <= 3)
    return row_pass_k<3, RECORDS>(i, m, D, row_vars, row_deg, llr_in, llr_tot,
                                  msg, first, check, update);
  if (warp_deg <= 5)
    return row_pass_k<5, RECORDS>(i, m, D, row_vars, row_deg, llr_in, llr_tot,
                                  msg, first, check, update);
  return row_pass_k<kMaxDegree, RECORDS>(i, m, D, row_vars, row_deg, llr_in,
                                         llr_tot, msg, first, check, update);
}

template <bool RECORDS>
__device__ __forceinline__ void var_pass_of(
    int n, int Dv, const int* __restrict__ var_edges,
    const int* __restrict__ var_deg, const float* llr_in, float* llr_tot,
    const float* msg) {
  if constexpr (RECORDS) {
    var_pass_records(n, Dv, var_edges, var_deg, llr_in, llr_tot,
                     reinterpret_cast<const uint2*>(msg));
  } else {
    var_pass(n, Dv, var_edges, var_deg, llr_in, llr_tot, msg);
  }
}

// RECORDS: bfloat16 messages kept as check-row records, and var_edges is
// the (row << 3 | slot) table; else float32 c2v and d-major edge indices.
template <int BLOCK, bool RECORDS>
__global__ void __launch_bounds__(BLOCK, 2048 / BLOCK) ldpc_minsum_kernel(
    const float* __restrict__ llr, const int* __restrict__ row_vars,
    const int* __restrict__ row_deg, const int* __restrict__ var_edges,
    const int* __restrict__ var_deg, float* __restrict__ llr_out, uint8_t* __restrict__ ok_out,
    int* __restrict__ iters_out, int n, int m, int D, int Dv,
    int max_iters) {
  extern __shared__ __align__(16) float smem[];
  float* llr_in = smem;           // [n]
  float* llr_tot = smem + n;      // [n]
  float* msg = smem + 2 * n;      // [D * m] c2v, d-major; RECORDS: [m] uint2
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
      noisy |= row_pass_sorted<RECORDS>(i, m, D, row_vars, row_deg, llr_in,
                                        llr_tot, msg, /*first=*/true,
                                        /*check=*/false, /*update=*/true);
    bool clean = !__syncthreads_or(noisy);
    var_pass_of<RECORDS>(n, Dv, var_edges, var_deg, llr_in, llr_tot, msg);
    __syncthreads();
    for (int it = 0;;) {
      // Syndrome of iteration `it`, fused with the check update of
      // iteration it + 1, which is discarded if the codeword converged --
      // so a clean codeword, which almost always converges here, skips it.
      const bool more = it + 1 < max_iters;
      int unsat = 0;
      for (int i = threadIdx.x; i < m; i += blockDim.x)
        unsat |= row_pass_sorted<RECORDS>(i, m, D, row_vars, row_deg, llr_in,
                                          llr_tot, msg, /*first=*/false,
                                          /*check=*/true,
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
      var_pass_of<RECORDS>(n, Dv, var_edges, var_deg, llr_in, llr_tot, msg);
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

template <bool RECORDS>
Kernel kernel_for(int threads) {
  switch (threads) {
    case 256: return ldpc_minsum_kernel<256, RECORDS>;
    case 1024: return ldpc_minsum_kernel<1024, RECORDS>;
    default: return nullptr;
  }
}

// Dynamic shared memory of one block: llr_in and llr_total, then D float32
// c2v per check row, or one 8-byte record per row.
size_t shared_bytes(int n, int m, int D, bool records) {
  return records ? (size_t)2 * n * sizeof(float) + (size_t)m * sizeof(uint2)
                 : (size_t)(2 * n + D * m) * sizeof(float);
}

int launch(Kernel kernel, bool records, const float* llr, const int* row_vars,
           const int* row_deg, const int* var_edges, const int* var_deg,
           float* llr_out, uint8_t* ok, int* iters, int B, int n, int m,
           int D, int Dv, int max_iters, int threads, void* stream) {
  if (kernel == nullptr || D > kMaxDegree || D < 1 || n < 4 || n % 4 != 0 ||
      m < 1 || Dv < 1 || max_iters < 0 || B < 0 ||
      ((uintptr_t)llr | (uintptr_t)llr_out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(n, m, D, records);
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
  return launch(kernel_for<false>(threads), false, llr, row_vars, row_deg,
                var_edges, var_deg, llr_out, ok, iters, B, n, m, D, Dv,
                max_iters, threads, stream);
}

// The same decoder with bfloat16 v2c messages, kept as check-row records
// (arguments as above, but var_slots [n, Dv] holds each variable's edges
// as (sorted row << 3 | slot), in the same order).
int ldpc_minsum_decode_bf16(const float* llr, const int* row_vars,
                            const int* row_deg, const int* var_slots,
                            const int* var_deg, float* llr_out, uint8_t* ok,
                            int* iters, int B, int n, int m, int D, int Dv,
                            int max_iters, int threads, void* stream) {
  return launch(kernel_for<true>(threads), true, llr, row_vars, row_deg,
                var_slots, var_deg, llr_out, ok, iters, B, n, m, D, Dv,
                max_iters, threads, stream);
}

// Dynamic shared bytes a block of the float32 (bf16 = 0) or the bfloat16
// decoder takes for a code of n variables and m check rows of degree <= D.
long long ldpc_minsum_shared_bytes(int n, int m, int D, int bf16) {
  return (long long)shared_bytes(n, m, D, bf16 != 0);
}

const char* ldpc_minsum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
