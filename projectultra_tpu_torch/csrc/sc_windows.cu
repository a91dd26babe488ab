// Schmidl-Cox sliding-window sums for Hopper (sm_90a): persistent blocks
// that walk (lane, tile) work items, each tile's samples staged once in
// shared memory by a TMA bulk copy through a ring of two stages.
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
// (R2[g] sums the partials half/stride blocks on, the same ones R1[g +
// half/stride] sums).  At stride 1 the blocks are single samples.  No sum is
// longer than the window, nothing is a difference of two running sums (the
// result stays block-stable on buffers of any length), a window over zeros
// adds zeros to 0, and an output adds exactly the products of its own
// window: a non-finite sample makes non-finite exactly the outputs whose
// windows hold it, as in the plain version.
//
// What bounds it on this card.  At stride 8 (the detection grid), device
// memory: at the Cox shape (B = 512, T = 18,856, G = 2,288) the span of
// samples is 77.0 MB and the outputs 18.7 MB, ~28.6 us at 3.35 TB/s.  At
// stride 1 (sc_metric), the window adds: 4 * half per output.
//
// The design (it replaces the earlier one, which loaded every sample from
// device memory twice -- once itself, once as the +half partner of an earlier
// sample -- and overlapped one tile's loads with another's window loops only
// across resident blocks; it ran at 41% of the bound at the Cox shape):
//   * Staging, by TMA bulk copy (cp.async.bulk ... mbarrier::complete_tx):
//     a work item's span [t0, t0 + stride * (n - 1) + 2 * half) is one
//     contiguous run of its row, so one thread issues it as one copy and the
//     copy engine computes no addresses in registers; its completion is the
//     byte count on the stage's mbarrier.  The body is copied from the even
//     sample at or below t0 (16-byte aligned: the row stride is even) up to
//     the last even sample boundary at or below T; the threads write what
//     lies past it (the odd last sample, zeros past T), since a bulk copy
//     fills no zeros.  cp.async.cg would need the same span as sixteen-byte
//     copies from every thread, with the zero fill in its source-size
//     operand, and twice the registers for addresses.
//   * The pre-reduction reads each sample and its +half partner from the
//     staged span, 16 bytes (two samples) a thread, neighbouring threads on
//     neighbouring float4s (conflict-free; the first version's 8-byte
//     loads at a 64-byte thread stride were 16-way conflicted); the
//     stride/2 threads of one block partial combine by warp shuffles.
//     Partials go to shared memory as three float arrays (energy,
//     correlation real and imaginary).
//   * Window loops: each thread sums four consecutive outputs of one
//     stream pair (P's real and imaginary parts, or R1 and R2), reading the
//     partials as float4s (neighbouring threads on neighbouring float4s) and
//     adding each float4 into all four sums that hold it, so a partial is
//     read once per four outputs instead of once per output: the earlier
//     loops were bound by shared-memory loads (three words per add), these
//     by the adds.
//   * Persistent blocks: the grid is the SM count times the blocks of this
//     shared-memory size that fit on one SM (the occupancy calculator),
//     capped at the number of items; each block walks items i, i + grid, ...
//     through a ring of two stages, each with its own mbarrier, whose phase
//     parity is the item's ring round.  A stage is refilled (the item two
//     on) as soon as its samples are pre-reduced, so that copy is in flight
//     through this item's window loops and the next item's pre-reduction.
//     (A one-stage ring measured ~5% faster at the Cox and NVIS shapes:
//     half the shared memory lets 5-6 blocks share an SM instead of 3,
//     and their copies hide a block's serial phases.)  When two stages
//     do not fit in shared memory (half above ~4,800 at stride 1) the
//     ring has one; above ~7,200 at stride 1 (~12,000 at
//     stride 8) not even one fits and the launch fails (the earlier design,
//     which staged no samples, took halves up to ~11,200 at stride 1).
//     The modem's plans use 256 and 512.
//   * The tile (outputs per item) is picked by ops/cuda_sc.py::tile_for
//     from B, G and the SM count: tiles of up to 512 outputs when they
//     give two items an SM, else of up to 128 (small batches are bound by
//     one item's latency); the tiles of a row as equal as multiples of 4
//     allow; and no more outputs than keep a stage within 34 KB, so that
//     three blocks of two stages fit an SM.  Cox: 5 tiles of 460 (no
//     ragged 240-output tile; the halo, 2*half/stride - 1 partials a
//     tile, 14%), 3 blocks an SM; NVIS (half 512): 5 of 352; the engine's
//     B = 1 view: 256 of 128 (the earlier design gave it 64 blocks for
//     132 SMs).
//     Measured (device ms, tools/torch_kernel_ab.py --tiles, H100 SXM at
//     700 W): Cox stride 8 at 128/256/384/460/512 outputs 0.0583/0.0458/
//     0.0443/0.0437/0.0453; NVIS 128/256/384/440/512 0.0608/0.0451/
//     0.0426/0.0449/0.0471 (440 fits two blocks an SM, 384 three); the
//     engine view 128/256/512 0.00377/0.00400/0.00493; B = 10, T = 39,936
//     128/184/256 0.00449/0.00492/0.00458; Cox stride 1 128/256/512
//     0.630/0.483/0.421.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // threads per block
constexpr int kMaxStages = 2;        // ring depth
constexpr int kBarBytes = 16;        // the stages' mbarriers; keeps the
                                     // partials after them 16-byte aligned
static_assert(kMaxStages * 8 <= kBarBytes, "mbarriers overflow their area");
constexpr unsigned kSpinLimit = 1u << 26;  // mbarrier polls before a trap

struct Params {
  const float2* a;
  long long lda;
  int T, half, stride, offset, G;
  int tile;       // outputs per work item (a multiple of 4)
  int per_row;    // items per lane: ceil(G / tile)
  int items;      // B * per_row
  int stages;     // ring depth, 1 or 2
  int stage_len;  // samples a stage holds
  int e_len;      // floats of the energy partials (a multiple of 4)
  int u_len;      // floats of each correlation partial array
};

// One work item: lane b, outputs [g0, g0 + n_work) (n_work rounded up to a
// multiple of 4; outputs at or past G are computed and not stored).  Its
// stage holds samples [tb, tb + n_stage) of the row: the first `body` by
// the bulk copy, the rest written by the threads.
struct Item {
  int b, g0, n_work, shift, n_stage, body;
  long long tb;
};

__device__ __forceinline__ Item item_of(const Params& p, int i) {
  Item it;
  it.b = i / p.per_row;
  it.g0 = (i - it.b * p.per_row) * p.tile;
  it.n_work = min(p.tile, (p.G - it.g0 + 3) & ~3);
  const long long t0 = p.offset + (long long)p.stride * it.g0;
  it.tb = t0 & ~1LL;
  it.shift = (int)(t0 - it.tb);
  const int span = p.stride * (it.n_work - 1) + 2 * p.half;
  // A spare pair past the span, so a float4 read of any pair the
  // pre-reduction touches stays inside the stage.
  it.n_stage = ((it.shift + span + 1) & ~1) + 2;
  const long long room = (long long)(p.T & ~1) - it.tb;
  it.body = (int)(room < 0 ? 0 : room < it.n_stage ? room : it.n_stage);
  return it;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (unsigned spins = 0;; ++spins) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    // A phase that never completes is a fault of this kernel: end the
    // launch with an error rather than hang the card.
    if (spins == kSpinLimit) __trap();
  }
}

// Thread 0: expect the item's body on the stage's mbarrier (one arrival)
// and start its bulk copy.
__device__ __forceinline__ void issue(const Params& p, const Item& it,
                                      float2* dst, uint32_t bar) {
  const uint32_t bytes = (uint32_t)it.body * (uint32_t)sizeof(float2);
  // Order the block's earlier generic-proxy reads of this stage before the
  // async-proxy writes of the copy.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
  if (bytes) {
    const float2* src = p.a + (long long)it.b * p.lda + it.tb;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  }
}

// All threads: the stage's samples past the body (the odd last sample of
// the row, zeros past T).  Disjoint from the bytes the copy writes.
__device__ __forceinline__ void fill_tail(const Params& p, const Item& it,
                                          float2* dst) {
  const float2* row = p.a + (long long)it.b * p.lda;
  for (int j = it.body + threadIdx.x; j < it.n_stage; j += kThreads) {
    const long long t = it.tb + j;
    dst[j] = t < p.T ? row[t] : make_float2(0.f, 0.f);
  }
}

// Starts item i into stage s of the ring (thread 0 copies, all fill).
__device__ __forceinline__ void start_item(const Params& p, int i,
                                           float2* stage, uint32_t bar) {
  const Item it = item_of(p, i);
  if (threadIdx.x == 0) issue(p, it, stage, bar);
  fill_tail(p, it, stage);
}

// Block partials of the staged span: energies s_e[k] for k < n_work +
// 2*hb - 1, correlations (s_ur, s_ui)[k] for k < n_work + hb - 1.
__device__ __forceinline__ void prereduce(const Params& p, const Item& it,
                                          const float2* stage, float* s_e,
                                          float* s_ur, float* s_ui) {
  const float4* x4 = reinterpret_cast<const float4*>(stage);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int hb = p.half / p.stride;
  const int n_e = it.n_work + 2 * hb - 1;
  const int n_u = it.n_work + hb - 1;
  const int partner = p.half / 2;  // float4s from a pair to its partner
  if (p.stride > 1) {
    // stride/2 threads a partial, a float4 (two samples) each; t0 is even.
    const int lanes = p.stride / 2;
    const int nf = n_e * lanes;  // a multiple of lanes: groups are whole
#pragma unroll 2
    for (int f0 = 0; f0 < nf; f0 += kThreads) {
      const int f = f0 + threadIdx.x;
      const int k = f / lanes;
      const bool in = f < nf;
      const float4 x = in ? x4[f] : zero;
      const float4 y = in && k < n_u ? x4[f + partner] : zero;
      float e = x.x * x.x + x.y * x.y + (x.z * x.z + x.w * x.w);
      float ur = x.x * y.x + x.y * y.y + (x.z * y.z + x.w * y.w);
      float ui = x.x * y.y - x.y * y.x + (x.z * y.w - x.w * y.z);
      for (int o = 1; o < lanes; o <<= 1) {
        e += __shfl_xor_sync(0xffffffffu, e, o);
        ur += __shfl_xor_sync(0xffffffffu, ur, o);
        ui += __shfl_xor_sync(0xffffffffu, ui, o);
      }
      if (in && (f & (lanes - 1)) == 0) {
        s_e[k] = e;
        if (k < n_u) {
          s_ur[k] = ur;
          s_ui[k] = ui;
        }
      }
    }
  } else {
    // One partial a sample: pair f holds partials 2f - shift, 2f - shift + 1.
    const int nf = (n_e + it.shift + 1) / 2;
    for (int f = threadIdx.x; f < nf; f += kThreads) {
      const int k = 2 * f - it.shift;
      const float4 x = x4[f];
      const float4 y = k < n_u ? x4[f + partner] : zero;
      if (k >= 0) {
        s_e[k] = x.x * x.x + x.y * x.y;
        if (k < n_u) {
          s_ur[k] = x.x * y.x + x.y * y.y;
          s_ui[k] = x.x * y.y - x.y * y.x;
        }
      }
      if (k + 1 < n_e) {
        s_e[k + 1] = x.z * x.z + x.w * x.w;
        if (k + 1 < n_u) {
          s_ur[k + 1] = x.z * y.z + x.w * y.w;
          s_ui[k + 1] = x.z * y.w - x.w * y.z;
        }
      }
    }
  }
}

// acc[i] += the elements of float4 v that lie in output i's window: all
// (kPart 1), those at or after lane i (0: the window's first float4), those
// before lane i (2: its last).  Each sum adds left to right.
template <int kPart>
__device__ __forceinline__ void add_chunk(float (&acc)[4], const float4 v) {
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (kPart == 1 || (kPart == 0 ? r >= i : r < i)) acc[i] += x[r];
}

// The window sums of four outputs 4q..4q+3 over two partial streams:
// sa[i] = sum_{m<hb} xa[4q+i+m], sb[i] likewise over xb.
__device__ __forceinline__ void window_sums(const float* xa, const float* xb,
                                            int q, int hb, float (&sa)[4],
                                            float (&sb)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) sa[i] = sb[i] = 0.f;
  if (hb % 4 == 0) {
    // A window of hb partials from 4q spans float4s q .. q + hb/4.
    const float4* a4 = reinterpret_cast<const float4*>(xa) + q;
    const float4* b4 = reinterpret_cast<const float4*>(xb) + q;
    const int nc = hb / 4;
    add_chunk<0>(sa, a4[0]);
    add_chunk<0>(sb, b4[0]);
#pragma unroll 4
    for (int c = 1; c < nc; ++c) {
      add_chunk<1>(sa, a4[c]);
      add_chunk<1>(sb, b4[c]);
    }
    add_chunk<2>(sa, a4[nc]);
    add_chunk<2>(sb, b4[nc]);
  } else {
    // hb not a multiple of 4 (a half of 2 or 6 at stride 1 or 2, ...):
    // scalar reads, bank conflicts and all.
    for (int m = 0; m < hb; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sa[i] += xa[4 * q + i + m];
        sb[i] += xb[4 * q + i + m];
      }
    }
  }
}

// Window sums of the item's outputs: unit w < nq sums P's real and
// imaginary parts of quad w, unit nq + q R1 and R2 of quad q.
__device__ __forceinline__ void windows(const Params& p, const Item& it,
                                        const float* s_e, const float* s_ur,
                                        const float* s_ui,
                                        float2* __restrict__ P,
                                        float* __restrict__ R1,
                                        float* __restrict__ R2) {
  const int hb = p.half / p.stride;
  const int nq = it.n_work / 4;
  for (int w = threadIdx.x; w < 2 * nq; w += kThreads) {
    const bool energy = w >= nq;
    const int q = energy ? w - nq : w;
    float sa[4], sb[4];
    window_sums(energy ? s_e : s_ur, energy ? s_e + hb : s_ui, q, hb, sa,
                sb);
    const int g = it.g0 + 4 * q;
    const long long o = (long long)it.b * p.G + g;
    const bool whole = g + 3 < p.G;
    if (!energy) {
      float2* dst = P + o;
      if (whole && ((uintptr_t)dst & 15) == 0) {
        float4* d4 = reinterpret_cast<float4*>(dst);
        d4[0] = make_float4(sa[0], sb[0], sa[1], sb[1]);
        d4[1] = make_float4(sa[2], sb[2], sa[3], sb[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (g + i < p.G) dst[i] = make_float2(sa[i], sb[i]);
      }
    } else {
      float* d1 = R1 + o;
      float* d2 = R2 + o;
      if (whole && (((uintptr_t)d1 | (uintptr_t)d2) & 15) == 0) {
        *reinterpret_cast<float4*>(d1) =
            make_float4(sa[0], sa[1], sa[2], sa[3]);
        *reinterpret_cast<float4*>(d2) =
            make_float4(sb[0], sb[1], sb[2], sb[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (g + i < p.G) {
            d1[i] = sa[i];
            d2[i] = sb[i];
          }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sc_windows_kernel(const Params p, float2* __restrict__ P,
                  float* __restrict__ R1, float* __restrict__ R2) {
  extern __shared__ __align__(128) unsigned char smem[];
  float2* stages = reinterpret_cast<float2*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + (size_t)p.stages * p.stage_len * sizeof(float2));
  float* s_e = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(bars) + kBarBytes);
  float* s_ur = s_e + p.e_len;
  float* s_ui = s_ur + p.u_len;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(smem_addr(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < p.stages; ++s) {
    const int i = blockIdx.x + s * gridDim.x;
    if (i < p.items)
      start_item(p, i, stages + (size_t)s * p.stage_len,
                 smem_addr(bars + s));
  }
  __syncthreads();  // the prologue's tail writes

  int n = 0;  // items this block has taken
  for (int i = blockIdx.x; i < p.items; i += gridDim.x, ++n) {
    const int s = n % p.stages;
    float2* stage = stages + (size_t)s * p.stage_len;
    const uint32_t bar = smem_addr(bars + s);
    const Item it = item_of(p, i);
    mbar_wait(bar, (uint32_t)(n / p.stages) & 1u);
    prereduce(p, it, stage, s_e, s_ur, s_ui);
    __syncthreads();  // partials written; the stage is read
    const int next = i + p.stages * gridDim.x;
    if (next < p.items) start_item(p, next, stage, bar);
    windows(p, it, s_e, s_ur, s_ui, P, R1, R2);
    __syncthreads();  // partials read; the refill's tail writes done
  }
}

bool valid_stride(int half, int stride) {
  // stride 1, or an even power of two whose stride/2 lanes fit in a warp.
  const bool pow2 = stride >= 1 && (stride & (stride - 1)) == 0;
  return pow2 && stride <= 64 && half >= stride && half % stride == 0;
}

int round_up4(long long n) { return (int)((n + 3) & ~3LL); }

// The ring's geometry for a tile (stage_len, e_len, u_len) and the
// dynamic shared bytes of a block with `stages` stages.
size_t layout(Params* p, int stages) {
  const int hb = p->half / p->stride;
  const long long span = (long long)p->stride * (p->tile - 1) + 2LL * p->half;
  p->stages = stages;
  p->stage_len = (int)(((1 + span + 1) & ~1LL) + 2);  // shift <= 1
  p->e_len = round_up4((long long)p->tile + 2LL * hb + 4);
  p->u_len = round_up4((long long)p->tile + hb + 4);
  return (size_t)stages * p->stage_len * sizeof(float2) + kBarBytes +
         ((size_t)p->e_len + 2 * (size_t)p->u_len) * sizeof(float);
}

// Ring depth, grid and shared bytes for p (tile, half, stride, items set)
// on the current device with `sms` SMs: two stages where they fit, the
// grid as many blocks as are resident at once, at most one an item.
cudaError_t plan(Params* p, int sms, int* grid, size_t* smem) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  for (int stages = kMaxStages; stages >= 1; --stages) {
    *smem = layout(p, stages);
    if (*smem > (size_t)optin) continue;
    if (*smem > 48 * 1024) {
      err = cudaFuncSetAttribute(sc_windows_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)*smem);
      if (err != cudaSuccess) return err;
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sc_windows_kernel, kThreads, *smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) continue;
    const long long resident = (long long)per_sm * sms;
    *grid = (int)(resident < p->items ? resident : p->items);
    return cudaSuccess;
  }
  return cudaErrorInvalidValue;  // no stage of this span fits a block
}

// Checks the arguments and fills p; 0 or a CUDA error code.
int setup(Params* p, const void* a, long long lda, int B, int T, int half,
          int stride, int offset, int G, int tile) {
  if (!valid_stride(half, stride) || half % 2 != 0 || B < 0 || G < 0 ||
      B > 65535 || offset < 0 || offset % stride != 0 || lda % 2 != 0 ||
      (uintptr_t)a % 16 != 0 || tile < 4 || tile % 4 != 0 ||
      (G > 0 && (long long)offset + (long long)stride * (G - 1) + 2LL * half >
                    (long long)T))
    return (int)cudaErrorInvalidValue;
  p->a = (const float2*)a;
  p->lda = lda;
  p->T = T;
  p->half = half;
  p->stride = stride;
  p->offset = offset;
  p->G = G;
  p->tile = tile;
  p->per_row = G > 0 ? (G + tile - 1) / tile : 0;
  const long long items = (long long)B * p->per_row;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p->items = (int)items;
  return 0;
}

}  // namespace

extern "C" {

// Launches the window sums for B lanes on `stream`, which belongs to the
// calling thread's current CUDA device (`sms` SMs), in work items of `tile`
// outputs; returns the CUDA error code of the launch (0 on success).  The
// caller guarantees offset + stride * (G - 1) + 2 * half <= T,
// offset % stride == 0, a 16-byte aligned `a`, an even `lda` and an even
// `half`.
int sc_windows_launch(const void* a, long long lda, int B, int T, int half,
                      int stride, int offset, int G, int tile, int sms,
                      void* P, void* R1, void* R2, void* stream) {
  Params p;
  const int bad = setup(&p, a, lda, B, T, half, stride, offset, G, tile);
  if (bad) return bad;
  if (p.items == 0) return 0;
  int grid = 0;
  size_t smem = 0;
  const cudaError_t err = plan(&p, sms, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  sc_windows_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      p, (float2*)P, (float*)R1, (float*)R2);
  return (int)cudaGetLastError();
}

// What sc_windows_launch would launch for these sizes on the current
// device: out[0] ring stages, out[1] blocks, out[2] dynamic shared bytes a
// block, out[3] work items; returns the CUDA error code (0 on success).
int sc_windows_plan(int B, int T, int half, int stride, int offset, int G,
                    int tile, int sms, long long* out) {
  Params p;
  const int bad = setup(&p, (const void*)0, 0, B, T, half, stride, offset,
                        G, tile);
  if (bad) return bad;
  int grid = 0;
  size_t smem = 0;
  const cudaError_t err = plan(&p, sms, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.stages;
  out[1] = p.items ? grid : 0;
  out[2] = (long long)smem;
  out[3] = p.items;
  return 0;
}

const char* sc_windows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
