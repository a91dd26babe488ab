// Pilot tracking, equalization and DQPSK demapping of one OFDM symbol for
// Hopper (sm_90a): one thread a lane.
//
// Replaces, for DQPSK on a pilot plan, the ~250 PyTorch operations a symbol
// of the pilot-tracking scan's step (projectultra_tpu_torch/ofdm/
// demodulator.py: update_channel_estimate, equalize's differential branch,
// demodulate_symbol; the JAX package's lax.scan body of the same
// functions).  Each operates on a lane's 15-30 used bins, so the step is a
// chain of tiny launches whose count, not their work, sets its time; this
// kernel does a lane's whole step in one thread.  Its plain version, the
// PyTorch operations, is its oracle.  The arithmetic follows them in
// float32, their order and their constants: LS pilots, the pilots'
// temporal noise, EMA smoothing, the residual CFO from the pilots' phase
// rotation, the timing slope's LS fit, the coherent timing fix around the
// linear / nearest-pilot interpolation, the noise and SNR updates, then
// equalization against the tracked estimate and the DQPSK demap against
// the previous symbol.  Sums over carriers run in carrier order (PyTorch's
// reductions may add in another order: results differ in the last bits).
//
// Complex values are float2 (re, im).  Divisions of a complex by a real
// follow c10::complex's: (a + b * rat) * scl with rat = 0 / c and
// scl = 1 / c.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Tables {
  const int* didx;             // [Cd] FFT bins of the data carriers
  const int* pidx;             // [Np] FFT bins of the pilots
  const float* pseq;           // [Np] pilot BPSK, +-1
  const float* pk;             // [Np] signed pilot bins
  const float* tp_pk;          // [Np] 2 pi k of the pilots, float32
  const float* tp_dk;          // [Cd] 2 pi k of the data carriers
  const int* ib;               // [Ci] interpolated bins
  const int* ilo;              // [Ci] lower pilot bin
  const int* iup;              // [Ci] upper pilot bin
  const float* ia;             // [Ci] blend factor
  const unsigned char* iboth;  // [Ci] both neighbours exist
  const unsigned char* ionly;  // [Ci] only the lower one exists
};

struct State {
  float* foh;                  // freq_offset_hz [B]
  float* fof;                  // freq_offset_filtered [B]
  float2* ce;                  // channel_estimate [B, N]
  float2* prev_eq;             // dbpsk_prev [B, Cd]
  float2* ppc;                 // pilot_phase_correction [B]
  float2* pil;                 // prev_pilot_phases [B, Np]
  unsigned char* have;         // have_prev_pilots [B]
  float* nv;                   // noise_variance [B]
  float* snr;                  // estimated_snr_linear [B]
  int* count;                  // snr_symbol_count [B]
  int* ssc;                    // symbols_since_sync [B]
  float* tos;                  // timing_offset_samples [B]
};

struct Consts {
  int B, Cd, Np, Ci, N, coherent;
  float inv_two_pi_sym;        // 1 / (2 pi symbol duration in s)
  float inv_two_pi;            // 1 / (2 pi), as slope * N / (2 pi)
  float inv_n;                 // 1 / N
  float max_t;                 // timing clamp, samples
};

constexpr int kMaxCarriers = 64;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cconj(float2 a) {
  return make_float2(a.x, -a.y);
}

__device__ __forceinline__ float cabs(float2 a) { return hypotf(a.x, a.y); }

__device__ __forceinline__ float2 cdiv_real(float2 a, float c) {
  const float rat = 0.0f / c;
  const float scl = 1.0f / (c + 0.0f * rat);
  return make_float2((a.x + a.y * rat) * scl, (a.y - a.x * rat) * scl);
}

__device__ __forceinline__ float2 cpolar(float angle) {
  return make_float2(cosf(angle), sinf(angle));
}

// clamp that keeps NaN, as torch.clamp does.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float clip_llr(float llr) {
  const float c = clampf(llr, -10.0f, 10.0f);
  return fabsf(c) < 0.5f ? (c >= 0.0f ? 0.5f : -0.5f) : c;
}

__global__ void pilot_track_kernel(const float2* __restrict__ fd,
                                   State in, State out,
                                   float* __restrict__ llr, Tables t,
                                   Consts k) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= k.B) return;
  const int Cd = k.Cd, Np = k.Np, N = k.N;
  const float2* f = fd + (long long)b * (Cd + Np);
  const float2* ce_in = in.ce + (long long)b * N;
  float2* ce = out.ce + (long long)b * N;
  const float2* prev = in.pil + (long long)b * Np;
  const bool have_prev = in.have[b] != 0;
  const int count = in.count[b];

  // LS pilots and the temporal noise against the previous symbol's.
  const float alpha = count == 0 ? 1.0f : 0.9f;
  float2 h_ls[kMaxCarriers];
  float hl2[kMaxCarriers];
  float signal_power = 0.0f;
  for (int p = 0; p < Np; ++p) {
    h_ls[p] = cdiv_real(f[Cd + p], t.pseq[p]);
    const float a = cabs(h_ls[p]);
    hl2[p] = a * a;
    signal_power += hl2[p];
  }
  signal_power *= 1.0f / (float)Np;
  float noise_sum = 0.0f;
  int noise_count = 0;
  float2 unit_sum = make_float2(0.0f, 0.0f);
  int vcount = 0;
  for (int p = 0; p < Np; ++p) {
    const float pm = cabs(prev[p]);
    const float pv2 = pm * pm;
    const bool valid = pv2 > 1e-6f && hl2[p] > 1e-6f && have_prev;
    const float2 diff = make_float2(h_ls[p].x - prev[p].x,
                                    h_ls[p].y - prev[p].y);
    const float dm = cabs(diff);
    noise_sum += valid ? dm * dm : 0.0f;
    noise_count += valid;
    // Residual CFO from the pilots' phase rotation.
    const float2 d = cmul(h_ls[p], cconj(prev[p]));
    const float dmag = cabs(d);
    const bool unit_ok = pv2 > 1e-6f && hl2[p] > 1e-6f && dmag > 1e-6f &&
                         have_prev;
    if (unit_ok) {
      const float2 u = cdiv_real(d, fmaxf(dmag, 1e-30f));
      unit_sum.x += u.x;
      unit_sum.y += u.y;
    }
    vcount += unit_ok;
  }
  if (noise_count == 0) noise_sum = signal_power * (1.0f / 31.6f);
  noise_count = noise_count < 1 ? 1 : noise_count;

  // EMA-smoothed estimate at the pilots.
  for (int p = 0; p < Np; ++p) {
    const float2 c = ce_in[t.pidx[p]];
    ce[t.pidx[p]] = make_float2(alpha * h_ls[p].x + (1.0f - alpha) * c.x,
                                alpha * h_ls[p].y + (1.0f - alpha) * c.y);
  }

  const bool have_cfo = vcount > 0;
  const float2 avg_diff =
      cdiv_real(unit_sum, (float)(vcount < 1 ? 1 : vcount));
  const float avg_phase = atan2f(avg_diff.y, avg_diff.x);
  const float2 ppc = have_cfo ? cpolar(-avg_phase) : make_float2(1.0f, 0.0f);
  const float residual = avg_phase * k.inv_two_pi_sym;
  const float foh_prev = in.foh[b], fof_prev = in.fof[b];
  const float total_cfo = foh_prev + residual;
  const int ssc_prev = in.ssc[b];
  const float progress =
      clampf((float)ssc_prev * (1.0f / 10.0f), 0.0f, 1.0f);
  float ad_alpha = 0.9f * (1.0f - progress) + 0.3f * progress;
  if (fabsf(residual) > 10.0f) ad_alpha = fmaxf(ad_alpha, 0.9f);
  const float fof = have_cfo
      ? ad_alpha * total_cfo + (1.0f - ad_alpha) * fof_prev : fof_prev;
  const float foh = have_cfo ? clampf(fof, -90.0f, 90.0f) : foh_prev;

  // Timing: LS fit of the pilots' phase against their bin.
  int nvalid = 0;
  float sum_k = 0.0f, sum_k2 = 0.0f, sum_p = 0.0f, sum_kp = 0.0f;
  for (int p = 0; p < Np; ++p) {
    const float m = hl2[p] >= 1e-6f ? 1.0f : 0.0f;
    const float kk = t.pk[p];
    const float ph = atan2f(h_ls[p].y, h_ls[p].x);
    nvalid += hl2[p] >= 1e-6f;
    sum_k += kk * m;
    sum_k2 += kk * kk * m;
    sum_p += ph * m;
    sum_kp += kk * ph * m;
  }
  const float denom = (float)nvalid * sum_k2 - sum_k * sum_k;
  const bool can_fit = count >= 3 && nvalid >= 3 && fabsf(denom) > 1e-6f;
  const float slope = ((float)nvalid * sum_kp - sum_k * sum_p) /
                      (can_fit ? denom : 1.0f);
  const float inst = slope * (float)N * k.inv_two_pi;
  const float tos_prev = in.tos[b];
  float tos = clampf(0.3f * inst + 0.7f * tos_prev, -k.max_t, k.max_t);
  tos = can_fit ? tos : tos_prev;

  // Coherent timing fix: de-rotate the pilots, interpolate, re-rotate.
  const bool tfix = k.coherent && fabsf(tos) > 0.1f;
  if (tfix) {
    for (int p = 0; p < Np; ++p)
      ce[t.pidx[p]] = cmul(ce[t.pidx[p]],
                           cpolar(-1.0f * (t.tp_pk[p] * tos * k.inv_n)));
  }
  for (int i = 0; i < k.Ci; ++i) {
    const float2 H1 = ce[t.ilo[i]], H2 = ce[t.iup[i]];
    const float2 pd = cmul(H2, cconj(H1));
    const float phase_diff = fabsf(atan2f(pd.y, pd.x));
    const float a = t.ia[i];
    const float2 lin = make_float2((1.0f - a) * H1.x + a * H2.x,
                                   (1.0f - a) * H1.y + a * H2.y);
    const float2 nearest = a < 0.5f ? H1 : H2;
    const float2 interp = phase_diff > 1.5708f ? nearest : lin;
    ce[t.ib[i]] = t.iboth[i] ? interp : (t.ionly[i] ? H1 : H2);
  }
  if (tfix) {
    for (int p = 0; p < Np; ++p)
      ce[t.pidx[p]] = cmul(ce[t.pidx[p]],
                           cpolar(1.0f * (t.tp_pk[p] * tos * k.inv_n)));
    for (int c = 0; c < Cd; ++c)
      ce[t.didx[c]] = cmul(ce[t.didx[c]],
                           cpolar(1.0f * (t.tp_dk[c] * tos * k.inv_n)));
  }

  // Noise variance and the SNR's EMA.
  const bool upd = noise_count > 1 && noise_sum > 0.0f;
  const float nv_prev = in.nv[b];
  const float nv = upd
      ? fmaxf(noise_sum / (float)(noise_count - 1 < 1 ? 1 : noise_count - 1),
              1e-6f)
      : nv_prev;
  const float inst_snr = clampf(signal_power / fmaxf(nv, 1e-30f), 0.1f,
                                10000.0f);
  const float snr_prev = in.snr[b];
  out.snr[b] = upd ? 0.3f * inst_snr + 0.7f * snr_prev : snr_prev;
  out.nv[b] = nv;
  out.foh[b] = foh;
  out.fof[b] = fof;
  out.tos[b] = tos;
  out.ppc[b] = ppc;
  out.have[b] = 1;
  out.count[b] = count + 1;
  out.ssc[b] = ssc_prev + (have_cfo ? 1 : 0);
  float2* pil = out.pil + (long long)b * Np;
  for (int p = 0; p < Np; ++p) pil[p] = h_ls[p];

  // Equalize against the tracked estimate, then demap against the
  // previous symbol (DQPSK: sin(phase + pi/4) and cos(2 phase)).
  const float2* prev_eq = in.prev_eq + (long long)b * Cd;
  float2* eq_out = out.prev_eq + (long long)b * Cd;
  float* l = llr + (long long)b * Cd * 2;
  for (int c = 0; c < Cd; ++c) {
    const float2 rx = f[c];
    const float2 h = ce[t.didx[c]];
    const float hm = cabs(h);
    const float hp = hm * hm;
    const float2 tc = cpolar(t.tp_dk[c] * tos * k.inv_n);
    const bool good = hp > 1e-6f;
    float2 eq = good ? cdiv_real(cmul(rx, cconj(h)), fmaxf(hp, 1e-30f)) : rx;
    eq = cmul(cmul(eq, ppc), tc);
    const float cnv = clampf(good ? nv / fmaxf(hp, 1e-30f) : 100.0f, 1e-6f,
                             100.0f) * 1.0f;
    const float2 pe = prev_eq[c];
    const float2 diff = cmul(eq, cconj(pe));
    const float phase = atan2f(diff.y, diff.x);
    const float sp = cabs(eq) * cabs(pe);
    const float scale = 2.0f * sp / cnv;
    const bool weak = sp < 1e-6f;
    l[2 * c] = weak ? 0.0f : clip_llr(scale * sinf(phase + 0.785398163397448f));
    l[2 * c + 1] = weak ? 0.0f : clip_llr(scale * cosf(2.0f * phase));
    eq_out[c] = eq;
  }
}

}  // namespace

extern "C" {

// One launch over B lanes on `stream` (the calling thread's current
// device).  `in` and `out` are the state fields in the order of State;
// `out.ce` must hold a copy of `in.ce` (the kernel writes the used bins
// only).  Returns the CUDA error code of the launch, or -1 when the plan
// has more carriers than the kernel holds.
int pilot_track_launch(const void* fd, void** in_fields, void** out_fields,
                       void* llr, const void** tables, int B, int Cd,
                       int Np, int Ci, int N, int coherent,
                       float inv_two_pi_sym, float inv_two_pi,
                       float inv_n, float max_t, void* stream) {
  if (Np > kMaxCarriers || Cd < 0 || Np < 0 || Ci < 0) return -1;
  if (B <= 0) return 0;
  auto state = [](void** f) {
    State s;
    s.foh = static_cast<float*>(f[0]);
    s.fof = static_cast<float*>(f[1]);
    s.ce = static_cast<float2*>(f[2]);
    s.prev_eq = static_cast<float2*>(f[3]);
    s.ppc = static_cast<float2*>(f[4]);
    s.pil = static_cast<float2*>(f[5]);
    s.have = static_cast<unsigned char*>(f[6]);
    s.nv = static_cast<float*>(f[7]);
    s.snr = static_cast<float*>(f[8]);
    s.count = static_cast<int*>(f[9]);
    s.ssc = static_cast<int*>(f[10]);
    s.tos = static_cast<float*>(f[11]);
    return s;
  };
  Tables t;
  t.didx = static_cast<const int*>(tables[0]);
  t.pidx = static_cast<const int*>(tables[1]);
  t.pseq = static_cast<const float*>(tables[2]);
  t.pk = static_cast<const float*>(tables[3]);
  t.tp_pk = static_cast<const float*>(tables[4]);
  t.tp_dk = static_cast<const float*>(tables[5]);
  t.ib = static_cast<const int*>(tables[6]);
  t.ilo = static_cast<const int*>(tables[7]);
  t.iup = static_cast<const int*>(tables[8]);
  t.ia = static_cast<const float*>(tables[9]);
  t.iboth = static_cast<const unsigned char*>(tables[10]);
  t.ionly = static_cast<const unsigned char*>(tables[11]);
  Consts k{B, Cd, Np, Ci, N, coherent, inv_two_pi_sym, inv_two_pi, inv_n,
           max_t};
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  pilot_track_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(fd), state(in_fields), state(out_fields),
      static_cast<float*>(llr), t, k);
  return static_cast<int>(cudaGetLastError());
}

const char* pilot_track_error_string(int err) {
  if (err == -1) return "more pilots than the kernel holds";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
