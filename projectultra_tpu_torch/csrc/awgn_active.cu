// The harness AWGN channel for Hopper (sm_90a): each frame's power over its
// active samples and the scaled noise added to it, in one launch.
//
// It replaces no TPU kernel.  It stands for XLA's fusion of
// projectultra_tpu/sim/watterson.py::add_noise_active and, in the port, for
// the 14 eager operations of the plain version
// (sim/watterson.add_noise_with_plain: abs, the compare, the square, where,
// the float and the int64 row sums, the clamp, the divides, sqrt, the scaled
// noise and the add), each a full pass over a [B, T] float32 array.  It was
// added on a measurement: on an H100 those took 3.16-3.20 ms a batch in the
// presynced benchmark cells (B = 16,384 frames of T = 7,332 samples), a third
// of the step, and 4.39 ms in the acquired cell (B = 2,048 x 83,808).
//
// For row b of samples x and standard normals z (both [B, T] float32):
//   active[t] = |x[t]| > 1e-6f          (a NaN sample is inactive)
//   sum       = float32 sum of x[t]*x[t] over the active t (each square
//               rounded, then added in the fixed tree order below)
//   power     = sum / max(count, 1)     (count: active samples, an integer)
//   std       = sqrt(power * inv_snr)   (a host SNR: PyTorch divides a CUDA
//               tensor by a CPU scalar as a product with its float32
//               reciprocal, which the host computes once), or
//               sqrt(power / snr[b])    (a device SNR, broadcast to rows)
//   y[t]      = x[t] + (std * z[t])     (the product and the sum each
//               rounded: __fmul_rn, __fadd_rn, no contraction)
// Divides and the square root are IEEE (__fdiv_rn, __fsqrt_rn).  Only the
// order of the power's sum differs from the plain version (PyTorch's
// reduction tree), so the two differ by float32 rounding of `std`; every
// NaN and infinity lands where the plain version puts it.  The sum order is
// fixed by the launch's shape, with no float atomics, so two runs are
// bitwise equal.
//
// What bounds it on this card.  Device memory: the samples and the noise are
// read once and the output written once, 3 x 4 B a sample: at the presynced
// cells' shape 1,441.6 MB, 0.430 ms at 3.35 TB/s (a second read of the
// samples, 4 passes, 0.574 ms).  A handful of float32 operations a sample
// take a tenth of that.
//
// The design: three regimes, one algorithm cut to the row's length.
// ops/cuda_awgn.py::launch_plan picks the regime and its sizes from (B, T)
// alone and passes them to awgn_active_launch, which checks them.
//   * Row (T <= kMaxSlice = 24,576 floats, 96 KiB): one block a row.  The
//     block stages its row in shared memory with cp.async copies of 16 bytes
//     (4 bytes where the row's start is not 16-byte aligned), each thread
//     summing the squares of the samples it copied, in order; the block's
//     threads then reduce (the xor butterfly in each warp, then the warps'
//     sums in order by thread 0), thread 0 forms `std`, and the block reads
//     the noise (ld.global.cs), adds the scaled noise to the staged samples
//     and writes the output (st.global.cs), 16 bytes at a time where the
//     noise's and the output's rows are aligned: 3 passes.
//   * Cluster (T <= kMaxParts x kMaxSlice = 196,608): a thread-block
//     cluster of kMaxParts = 8 blocks a row, each staging one slice of the
//     row as above.  Each block's thread 0 leaves the block's (sum, count) in
//     its shared memory; after a cluster barrier, each block's thread 0 reads
//     all of them through distributed shared memory in rank order, so every
//     block forms the same `std`; a second barrier, waited on only before
//     the block exits, keeps each block's shared memory alive until the
//     others have read it.  3 passes.
//   * Stream (longer rows: the engine's and the tools' 1-D buffers of a few
//     hundred thousand to millions of samples): a cooperative launch of as
//     many blocks as the card holds at once walks work items of `slice`
//     samples, each item's block writing its (sum, count) to a workspace;
//     after a grid barrier the blocks walk their items again in reverse order
//     (the last read are the likeliest still in L2), each forming its row's
//     `std` from the row's partials in item order, and read the samples a
//     second time: 4 passes.
// A row block has the power of two of threads above 6 16-byte copies a
// thread (at most 1,024).  Measured on an H100 (700 W), device ms: presynced
// 0.484-0.489 (88-89% of the 3-pass bound; 256 threads 0.501), the Cox cell's
// 2,048 x 18,856 0.162 (85%), the acquired cell in clusters of 8 0.708 (87%;
// clusters of 7 0.722, of 4 0.758; the same rows streamed twice 0.966).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;       // threads a row block, at most
constexpr int kMaxSlice = 24576;        // floats a row block stages, at most
constexpr int kMaxParts = 8;            // blocks a cluster (the portable limit)
constexpr int kStreamThreads = 256;     // threads a stream block
constexpr int kStreamUnroll = 8;        // 16-byte loads a thread has in flight
constexpr float kThreshold = 1e-6f;     // |x| above it is active

struct Params {
  const float* x;      // samples [B, T], row stride ldx
  long long ldx;
  const float* z;      // standard normals [B, T], row stride ldz
  long long ldz;
  float* y;            // output [B, T], row stride ldy
  long long ldy;
  const float* snr;    // linear SNR a row (element b * snr_step), or null
  long long snr_step;
  float inv_snr;       // the host SNR's float32 reciprocal, when snr is null
  int B;
  int T;
  int slice;           // samples a block (row, cluster) or an item (stream)
  int parts;           // blocks (row, cluster) or items (stream) a row
  float* part;         // stream: (sum, count as int) a work item
};

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// Adds v's square to sum, and 1 to count, where v is active (a NaN is not).
__device__ __forceinline__ void add_power(float v, float& sum, int& count) {
  const bool active = fabsf(v) > kThreshold;
  sum = __fadd_rn(sum, active ? __fmul_rn(v, v) : 0.0f);
  count += active;
}

__device__ __forceinline__ void add_power4(float4 v, float& sum,
                                           int& count) {
  add_power(v.x, sum, count);
  add_power(v.y, sum, count);
  add_power(v.z, sum, count);
  add_power(v.w, sum, count);
}

__device__ __forceinline__ float noisy(float x, float sd, float z) {
  return __fadd_rn(x, __fmul_rn(sd, z));
}

__device__ __forceinline__ float4 noisy4(float4 x, float sd, float4 z) {
  return make_float4(noisy(x.x, sd, z.x), noisy(x.y, sd, z.y),
                     noisy(x.z, sd, z.z), noisy(x.w, sd, z.w));
}

// The block's sum and count in thread 0, in a fixed order: each warp's by
// the xor butterfly, then the warps' in order.  ws and wc hold a word a warp.
__device__ __forceinline__ void block_sum(float& sum, int& count, float* ws,
                                          int* wc) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    count += __shfl_xor_sync(0xffffffffu, count, o);
  }
  const int warp = threadIdx.x / kWarp;
  if (threadIdx.x % kWarp == 0) {
    ws[warp] = sum;
    wc[warp] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x / kWarp); ++w) {
      sum = __fadd_rn(sum, ws[w]);
      count += wc[w];
    }
  }
}

__device__ __forceinline__ float noise_std(float sum, int count,
                                           const Params& p, int b) {
  const float power = __fdiv_rn(sum, (float)max(count, 1));
  const float r = p.snr != nullptr
                      ? __fdiv_rn(power, p.snr[(long long)b * p.snr_step])
                      : __fmul_rn(power, p.inv_snr);
  return __fsqrt_rn(r);
}

// Copies samples [0, len) of row r to sm and sums, in each thread, the
// powers of the samples it copied (zeros fill the last 16 bytes).
__device__ __forceinline__ void stage(float* sm, const float* r, int len,
                                      float& sum, int& count) {
  const int tid = threadIdx.x, threads = blockDim.x;
  if (aligned16(r)) {
    const int n4 = (len + 3) / 4;
    for (int c = tid; c < n4; c += threads)
      copy16(sm + 4 * c, r + 4 * c, 4 * min(4, len - 4 * c));
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    const float4* s4 = reinterpret_cast<const float4*>(sm);
    for (int c = tid; c < n4; c += threads) add_power4(s4[c], sum, count);
  } else {
    for (int s = tid; s < len; s += threads) copy4(sm + s, r + s);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    for (int s = tid; s < len; s += threads) add_power(sm[s], sum, count);
  }
}

// y[s] = x[s] + sd * z[s] for s in [0, len), the samples x from shared
// memory, z and y from the slice's start in device memory.
__device__ __forceinline__ void write_slice(const float* sm,
                                            const float* __restrict__ z,
                                            float* __restrict__ y, int len,
                                            float sd) {
  const int tid = threadIdx.x, threads = blockDim.x;
  int done = 0;
  if (aligned16(z) && aligned16(y)) {
    const int n4 = len / 4;
    const float4* x4 = reinterpret_cast<const float4*>(sm);
    const float4* z4 = reinterpret_cast<const float4*>(z);
    float4* y4 = reinterpret_cast<float4*>(y);
#pragma unroll 4
    for (int c = tid; c < n4; c += threads)
      __stcs(y4 + c, noisy4(x4[c], sd, __ldcs(z4 + c)));
    done = 4 * n4;
  }
  for (int s = done + tid; s < len; s += threads)
    __stcs(y + s, noisy(sm[s], sd, __ldcs(z + s)));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Row and cluster regimes: block rank of row b holds samples
// [rank * slice, rank * slice + slice) of it.
__global__ void __launch_bounds__(kMaxThreads)
awgn_rows_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ float ws[kMaxThreads / kWarp];
  __shared__ int wc[kMaxThreads / kWarp];
  __shared__ float part_sum, sd_row;
  __shared__ int part_count;
  const int b = (int)(blockIdx.x / (unsigned)p.parts);
  const int rank = (int)(blockIdx.x - (unsigned)b * p.parts);
  const long long s0 = (long long)rank * p.slice;
  const int len = (int)max(0LL, min((long long)p.slice, (long long)p.T - s0));
  float sum = 0.0f;
  int count = 0;
  stage(sm, p.x + b * p.ldx + s0, len, sum, count);
  block_sum(sum, count, ws, wc);
  if (p.parts == 1) {
    if (threadIdx.x == 0) sd_row = noise_std(sum, count, p, b);
    __syncthreads();
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      part_sum = sum;
      part_count = count;
    }
    cluster.sync();
    if (threadIdx.x == 0) {
      float total = 0.0f;
      int n = 0;
      for (int r = 0; r < p.parts; ++r) {
        total = __fadd_rn(total, *cluster.map_shared_rank(&part_sum, r));
        n += *cluster.map_shared_rank(&part_count, r);
      }
      sd_row = noise_std(total, n, p, b);
    }
    cluster_arrive();  // this block has read the others' partials
    __syncthreads();
  }
  write_slice(sm, p.z + b * p.ldz + s0, p.y + b * p.ldy + s0, len, sd_row);
  if (p.parts > 1) cluster_wait();
}

// The powers of samples [0, len) of row r, read from device memory, in each
// thread.
__device__ __forceinline__ void item_power(const float* __restrict__ r,
                                           int len, float& sum, int& count) {
  const int tid = threadIdx.x;
  int done = 0;
  if (aligned16(r)) {
    const int n4 = len / 4;
    const float4* r4 = reinterpret_cast<const float4*>(r);
    for (int c0 = 0; c0 < n4; c0 += kStreamUnroll * kStreamThreads) {
      float4 v[kStreamUnroll];
#pragma unroll
      for (int u = 0; u < kStreamUnroll; ++u) {
        const int c = c0 + u * kStreamThreads + tid;
        v[u] = c < n4 ? __ldcg(r4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kStreamUnroll; ++u) add_power4(v[u], sum, count);
    }
    done = 4 * n4;
  }
  for (int s = done + tid; s < len; s += kStreamThreads)
    add_power(__ldcg(r + s), sum, count);
}

// y[s] = x[s] + sd * z[s] for s in [0, len), all three in device memory.
__device__ __forceinline__ void item_write(const float* __restrict__ x,
                                           const float* __restrict__ z,
                                           float* __restrict__ y, int len,
                                           float sd) {
  const int tid = threadIdx.x;
  int done = 0;
  if (aligned16(x) && aligned16(z) && aligned16(y)) {
    const int n4 = len / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* z4 = reinterpret_cast<const float4*>(z);
    float4* y4 = reinterpret_cast<float4*>(y);
    for (int c0 = 0; c0 < n4; c0 += (kStreamUnroll / 2) * kStreamThreads) {
      float4 a[kStreamUnroll / 2], n[kStreamUnroll / 2];
#pragma unroll
      for (int u = 0; u < kStreamUnroll / 2; ++u) {
        const int c = c0 + u * kStreamThreads + tid;
        if (c < n4) {
          a[u] = __ldcs(x4 + c);
          n[u] = __ldcs(z4 + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kStreamUnroll / 2; ++u) {
        const int c = c0 + u * kStreamThreads + tid;
        if (c < n4) __stcs(y4 + c, noisy4(a[u], sd, n[u]));
      }
    }
    done = 4 * n4;
  }
  for (int s = done + tid; s < len; s += kStreamThreads)
    __stcs(y + s, noisy(__ldcs(x + s), sd, __ldcs(z + s)));
}

// Stream regime: a cooperative launch; item i is samples
// [(i % parts) * slice, ... + slice) of row i / parts.
__global__ void __launch_bounds__(kStreamThreads)
awgn_stream_kernel(const Params p) {
  __shared__ float ws[kStreamThreads / kWarp];
  __shared__ int wc[kStreamThreads / kWarp];
  __shared__ float sd_row;
  int* part_count = reinterpret_cast<int*>(p.part);
  const long long items = (long long)p.B * p.parts;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = (int)(it / p.parts);
    const long long s0 = (it - (long long)b * p.parts) * p.slice;
    const int len = (int)min((long long)p.slice, (long long)p.T - s0);
    float sum = 0.0f;
    int count = 0;
    item_power(p.x + b * p.ldx + s0, len, sum, count);
    block_sum(sum, count, ws, wc);
    if (threadIdx.x == 0) {
      p.part[2 * it] = sum;
      part_count[2 * it + 1] = count;
    }
    __syncthreads();  // ws and wc are the next item's
  }
  cg::this_grid().sync();
  if ((long long)blockIdx.x >= items) return;
  const long long last =
      blockIdx.x + (items - 1 - blockIdx.x) / gridDim.x * gridDim.x;
  for (long long it = last; it >= (long long)blockIdx.x; it -= gridDim.x) {
    const int b = (int)(it / p.parts);
    const long long s0 = (it - (long long)b * p.parts) * p.slice;
    const int len = (int)min((long long)p.slice, (long long)p.T - s0);
    if (threadIdx.x == 0) {
      float total = 0.0f;
      int n = 0;
      const long long first = (long long)b * p.parts;
      for (int k = 0; k < p.parts; ++k) {
        total = __fadd_rn(total, __ldcg(p.part + 2 * (first + k)));
        n += __ldcg(part_count + 2 * (first + k) + 1);
      }
      sd_row = noise_std(total, n, p, b);
    }
    __syncthreads();
    item_write(p.x + b * p.ldx + s0, p.z + b * p.ldz + s0,
               p.y + b * p.ldy + s0, len, sd_row);
    __syncthreads();  // sd_row is the next item's
  }
}

size_t rows_shared_bytes(int slice) { return sizeof(float) * (size_t)slice; }

// Checks the plan and the arguments and fills p; 0 or a CUDA error code.
int setup(Params* p, const void* x, long long ldx, const void* z,
          long long ldz, void* y, long long ldy, const void* snr,
          long long snr_step, float inv_snr, int B, int T, int stream_regime,
          int slice, int parts, int threads, void* part) {
  if (B < 0 || T < 0 || slice < 4 || slice % 4 != 0 || parts < 1 ||
      (long long)slice * parts < T ||
      (T > 0 && (long long)slice * (parts - 1) >= T) ||
      (uintptr_t)x % 4 != 0 || (uintptr_t)z % 4 != 0 ||
      (uintptr_t)y % 4 != 0 || (B > 1 && (ldx < 0 || ldz < 0 || ldy < T)) ||
      (long long)B * parts > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (stream_regime) {
    if (threads != kStreamThreads || (part == nullptr && B > 0 && T > 0))
      return (int)cudaErrorInvalidValue;
  } else if (slice > kMaxSlice || parts > kMaxParts || threads < kWarp ||
             threads > kMaxThreads || threads % kWarp != 0) {
    return (int)cudaErrorInvalidValue;
  }
  p->x = (const float*)x;
  p->ldx = ldx;
  p->z = (const float*)z;
  p->ldz = ldz;
  p->y = (float*)y;
  p->ldy = ldy;
  p->snr = (const float*)snr;
  p->snr_step = snr_step;
  p->inv_snr = inv_snr;
  p->B = B;
  p->T = T;
  p->slice = slice;
  p->parts = parts;
  p->part = (float*)part;
  return 0;
}

// Stream blocks the current device holds at once.
cudaError_t stream_grid(long long items, int* grid, int* per_sm) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, awgn_stream_kernel, kStreamThreads, 0);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)*per_sm * sms;
  *grid = (int)(items < resident ? items : resident);
  return cudaSuccess;
}

// The row kernel's limit of dynamic shared memory, the same at every launch
// (host threads may launch at once).
cudaError_t allow_shared() {
  return cudaFuncSetAttribute(awgn_rows_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)rows_shared_bytes(kMaxSlice));
}

}  // namespace

extern "C" {

// Launches the channel over B rows of T samples on `stream` (of the calling
// thread's current CUDA device); returns the CUDA error code of the launch
// (0 on success).  The plan (stream_regime, slice, parts, threads) is
// ops/cuda_awgn.py::launch_plan's.  snr is a device array of the linear SNR
// (row b's at b * snr_step) or null, and then inv_snr is the reciprocal of
// the host's.  y must not overlap x or z.  The stream regime needs `part`,
// a device workspace of 2 * B * parts words.
int awgn_active_launch(const void* x, long long ldx, const void* z,
                       long long ldz, void* y, long long ldy, const void* snr,
                       long long snr_step, float inv_snr, int B, int T,
                       int stream_regime, int slice, int parts, int threads,
                       void* part, void* stream) {
  Params p;
  const int bad = setup(&p, x, ldx, z, ldz, y, ldy, snr, snr_step, inv_snr,
                        B, T, stream_regime, slice, parts, threads, part);
  if (bad) return bad;
  if (B == 0 || T == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (stream_regime) {
    int grid = 0, per_sm = 0;
    err = stream_grid((long long)B * parts, &grid, &per_sm);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&p};
    err = cudaLaunchCooperativeKernel((const void*)awgn_stream_kernel,
                                      dim3(grid), dim3(kStreamThreads), args,
                                      0, s);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  err = allow_shared();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = rows_shared_bytes(slice);
  if (parts == 1) {
    awgn_rows_kernel<<<(unsigned)B, threads, smem, s>>>(p);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)B * parts));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, awgn_rows_kernel, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// What awgn_active_launch would launch for this plan on the current device:
// out[0] blocks, out[1] threads a block, out[2] dynamic shared bytes a
// block, out[3] blocks an SM can hold (the row kernel alone, without the
// cluster's placement); returns the CUDA error code.
int awgn_active_plan(int B, int T, int stream_regime, int slice, int parts,
                     int threads, long long* out) {
  Params p;
  int bad = setup(&p, (const void*)0, T, (const void*)0, T, (void*)0, T,
                  nullptr, 0, 1.0f, B, T, stream_regime, slice, parts,
                  threads, (void*)16);
  if (bad) return bad;
  int per_sm = 0;
  cudaError_t err;
  if (stream_regime) {
    int grid = 0;
    err = stream_grid((long long)B * parts, &grid, &per_sm);
    if (err != cudaSuccess) return (int)err;
    out[0] = grid;
    out[2] = 0;
  } else {
    err = allow_shared();
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, awgn_rows_kernel, threads, rows_shared_bytes(slice));
    if (err != cudaSuccess) return (int)err;
    out[0] = (long long)B * parts;
    out[2] = (long long)rows_shared_bytes(slice);
  }
  out[1] = stream_regime ? kStreamThreads : threads;
  out[3] = per_sm;
  return 0;
}

// The kernel's fixed sizes.
int awgn_active_max_slice(void) { return kMaxSlice; }
int awgn_active_max_parts(void) { return kMaxParts; }
int awgn_active_max_threads(void) { return kMaxThreads; }
int awgn_active_stream_threads(void) { return kStreamThreads; }

const char* awgn_active_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
