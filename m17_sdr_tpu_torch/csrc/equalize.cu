// The frame equalizer stage of one rx_block call (K4): the frames [B, F, 192]
// f32 that the receiver scan extracted, the slots holding a parsed frame,
// and each channel's carried taps, eye estimate and armed flag in; the
// equalized frames and the new taps, eye estimate and flag out, in one
// launch.
//
// Replaces no TPU kernel.  The JAX package runs this stage
// (m17_sdr_tpu/pipeline/rx.py:_decode_soft, m17_sdr_tpu/dsp/equalize.py:
// equalize_frames) as XLA ops under lax.cond; the port's plain version,
// m17_sdr_tpu_torch/dsp/equalize.py:equalize_stage_ref, is a Python loop
// over the F slots of many small launches each (windows, sums, the 5x5
// solve, blends) plus the eye statistic's, which the host issues one by
// one (an eager stage with einsums and a batched solve issued ~660 for a
// whole-session call; without this kernel the host paced it).  Each channel's
// recursion is sequential across its frames (frame i's taps come from
// frame i-1), so no eager op batches across it.  This kernel keeps a
// channel's whole recursion in one warp and must agree with the plain
// version bit for bit on every output.
//
// What bounds it on an H100: at [16384, 15, 192] the frames are 189 MB in
// and 189 MB out, 113 us at 3.35 TB/s.  A frame that adapts adds ~8000
// float64 operations (20 exact products a symbol and their sums, the 5x5
// solve), at half the card's float32 rate.  Measured on an H100: 0.49 ms
// with every channel armed, 0.36 ms with none, so neither the bytes nor
// the float64 rate alone sets the time: a warp's chain of dependent steps
// a frame (loads, shuffles, the solve's reciprocals) at 16 warps an SM.
//
// Design.  One warp a channel, four channels a block.  A frame is read
// coalesced into shared memory, padded by two copies of its edge symbols
// on each side (the plain version's edge-clamped windows); lanes 0..23
// then take 8 consecutive symbols each.  With auto arming, a first pass
// over the channel's frames computes the eye statistic and the new armed
// flag; an unarmed channel's frames are then copied through and its taps
// kept, and an armed channel (every channel with the stage on) is
// equalized frame by frame in a second pass: the 5-tap filter with the
// taps as of that frame; where the slot holds a parsed frame, the sync
// scale and the 4FSK targets, the 15 distinct entries of X^T X and the 5 of
// X^T d, the LDL^T solve, the blend and the non-finite guard.  Every lane
// runs the solve on the same numbers, so the taps stay the same in every
// lane with no broadcast.
//
// Numerics: the sums over a frame's symbols are pairwise_sum's float64
// tree exactly: a lane's 8 symbols as a tree of adjacent pairs, then lane
// pairs, fours and eights, then the three 64-symbol sums as (s0 + s1) +
// (s2 + 0); for the 20 sums of the update each lane's 8-symbol sums go
// through shared memory and lane q adds quantity q's 24 leaves in the same
// order.  Products of two float32 values in float64 are exact.  Float32
// and float64 arithmetic through the _rn intrinsics in the plain version's
// order, and the file is built with --fmad=false; divisions and
// reciprocals correctly rounded, as PyTorch's on CUDA between tensors; each
// constant rounded to float from the double that the plain version's
// Python number holds; clamp, minimum and maximum propagate NaN as
// PyTorch's do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kKN = 5;                  // taps
constexpr int kN = 192;                 // symbols a frame
constexpr int kSync = 8;                // leading sync symbols
constexpr int kPer = 8;                 // consecutive symbols a lane takes
constexpr int kLanes = kN / kPer;       // lanes holding a frame: 24
constexpr int kWarps = 4;               // channels a block
constexpr int kQ = 20;                  // 15 distinct X^T X entries, 5 of X^T d
constexpr unsigned kFull = 0xffffffffu;

constexpr float kFloor = (float)1e-9;       // clamp of the sync magnitude and scale
constexpr float kThird = (float)(1.0 / 3.0);
constexpr float kOne = 1.0f;
constexpr float kLevel = (float)0.15;       // a frame carries signal above this level
constexpr float kArm = (float)0.155;        // EYE_ARM
constexpr float kDisarm = (float)0.135;     // EYE_DISARM
constexpr float kSmooth = (float)0.5;       // EYE_SMOOTH and 1 - EYE_SMOOTH
constexpr float kMu = (float)0.5;           // EQ_FRAME_MU
constexpr double kLambda = 1e-3;            // EQ_FRAME_LAMBDA

struct Params {
  const float* frames;
  const uint8_t* valid;
  const float* c;
  const float* eye;
  const uint8_t* armed;
  float* out;
  float* c_out;
  float* eye_out;
  uint8_t* armed_out;
  int b, f, autoarm;
};

struct WarpSmem {
  float xs[kN + 4];                     // xs[n + 2] = symbol n, edges repeated twice
  double part[kQ][kLanes + 1];          // each lane's 8-symbol sums of the 20 quantities
  double tot[kQ];
};

__device__ __forceinline__ double tree8(const double* v) {
  return __dadd_rn(__dadd_rn(__dadd_rn(v[0], v[1]), __dadd_rn(v[2], v[3])),
                   __dadd_rn(__dadd_rn(v[4], v[5]), __dadd_rn(v[6], v[7])));
}

// The 192-symbol tree from lanes 0..23's 8-symbol sums: lane pairs, fours
// and eights by xor shuffles (a + b equals b + a bit for bit), then the
// three 64-symbol sums with the zero the padding to 256 adds.  Every lane
// gets the sum.
__device__ __forceinline__ double tree_lanes(double v) {
  v = __dadd_rn(v, __shfl_xor_sync(kFull, v, 1));
  v = __dadd_rn(v, __shfl_xor_sync(kFull, v, 2));
  v = __dadd_rn(v, __shfl_xor_sync(kFull, v, 4));
  const double g0 = __shfl_sync(kFull, v, 0);
  const double g1 = __shfl_sync(kFull, v, 8);
  const double g2 = __shfl_sync(kFull, v, 16);
  return __dadd_rn(__dadd_rn(g0, g1), __dadd_rn(g2, 0.0));
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}

// A frame row, read coalesced: lane l holds symbols l, l + 32, ..., l + 160.
// Each pass reads the next frame's row before it works on the current one,
// so that the loads are in flight meanwhile.
__device__ __forceinline__ void read_row(const float* __restrict__ src, int lane,
                                         float row[kN / 32]) {
#pragma unroll
  for (int i = 0; i < kN / 32; ++i) row[i] = src[lane + 32 * i];
}

// Puts a row into the padded shared row, then hands lane l < 24 its 8
// symbols and their 4 neighbours: win[m] = symbol 8l - 2 + m.
__device__ __forceinline__ void stage_row(const float row[kN / 32], float* xs, int lane,
                                          float win[kPer + 4]) {
  __syncwarp();                         // the last frame's reads are done
#pragma unroll
  for (int i = 0; i < kN / 32; ++i) xs[2 + lane + 32 * i] = row[i];
  if (lane == 0) { xs[0] = row[0]; xs[1] = row[0]; }
  if (lane == 31) { xs[kN + 2] = row[kN / 32 - 1]; xs[kN + 3] = row[kN / 32 - 1]; }
  __syncwarp();
  if (lane < kLanes) {
#pragma unroll
    for (int m = 0; m < kPer + 4; ++m) win[m] = xs[kPer * lane + m];
  }
}

// LDL^T solve of the symmetric system a (lower triangle used) for rhs, as
// dsp/equalize.py:_solve5 does it.
__device__ __forceinline__ void solve5(const double a[kKN][kKN], const double rhs[kKN],
                                       double x[kKN]) {
  double lo[kKN][kKN], dg[kKN], r[kKN], z[kKN];
#pragma unroll
  for (int j = 0; j < kKN; ++j) {
    double ld[kKN];
#pragma unroll
    for (int k = 0; k < j; ++k) ld[k] = __dmul_rn(lo[j][k], dg[k]);
    double t = a[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) t = __dsub_rn(t, __dmul_rn(lo[j][k], ld[k]));
    dg[j] = t;
    r[j] = __drcp_rn(t);
#pragma unroll
    for (int i = j + 1; i < kKN; ++i) {
      double s = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = __dsub_rn(s, __dmul_rn(lo[i][k], ld[k]));
      lo[i][j] = __dmul_rn(s, r[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < kKN; ++i) {
    double t = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t = __dsub_rn(t, __dmul_rn(lo[i][k], z[k]));
    z[i] = t;
  }
#pragma unroll
  for (int i = kKN - 1; i >= 0; --i) {
    double t = __dmul_rn(z[i], r[i]);
#pragma unroll
    for (int k = i + 1; k < kKN; ++k) t = __dsub_rn(t, __dmul_rn(lo[k][i], x[k]));
    x[i] = t;
  }
}

__global__ void __launch_bounds__(kWarps * 32) equalize_kernel(Params p) {
  __shared__ WarpSmem smem[kWarps];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int ch = blockIdx.x * kWarps + w;
  if (ch >= p.b) return;                // the whole warp
  WarpSmem& s = smem[w];
  const size_t base = (size_t)ch * p.f;
  float win[kPer + 4];
#pragma unroll
  for (int m = 0; m < kPer + 4; ++m) win[m] = 0.0f;

  // ---- the eye statistic and the arming rule (auto only)
  const float eye0 = p.eye[ch];
  const bool armed0 = p.armed[ch] != 0;
  float eye = eye0;
  bool armed = armed0;
  if (p.autoarm) {
    int nsig = 0;
    float d_sum = 0.0f, d_now = 0.0f;
    float row[kN / 32], next[kN / 32] = {};
    read_row(p.frames + base * kN, lane, row);
    for (int fi = 0; fi < p.f; ++fi) {
      if (fi + 1 < p.f) read_row(p.frames + (base + fi + 1) * kN, lane, next);
      stage_row(row, s.xs, lane, win);
#pragma unroll
      for (int i = 0; i < kN / 32; ++i) row[i] = next[i];
      double av[kPer], dv[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) av[j] = (double)fabsf(win[j + 2]);
      const double sync = __shfl_sync(kFull, tree8(av), 0);
      const float cor = __frcp_rn(clamp_min((float)__ddiv_rn(sync, (double)kSync), kFloor));
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float mag = __fmul_rn(fabsf(win[j + 2]), cor);
        const float disp = nan_min(fabsf(__fsub_rn(mag, kThird)), fabsf(__fsub_rn(mag, kOne)));
        dv[j] = (lane == 0 && j < kSync) ? 0.0 : (double)disp;   // the zero padding
      }
      const double dsum = tree_lanes(tree8(dv));
      const double lsum = tree_lanes(tree8(av));
      const float d_frame = (float)__ddiv_rn(dsum, (double)(kN - kSync));
      const float lvl = (float)__ddiv_rn(lsum, (double)kN);
      const bool sig = p.valid[base + fi] != 0 && lvl > kLevel;
      const float d_sig = sig ? d_frame : 0.0f;
      nsig += sig;
      d_sum = fi == 0 ? d_sig : __fadd_rn(d_sum, d_sig);
      d_now = fi == 0 ? d_sig : nan_max(d_now, d_sig);
    }
    const float d_mean = __fdiv_rn(d_sum, (float)(nsig > 1 ? nsig : 1));
    if (nsig > 0)
      eye = eye0 > 0.0f ? __fadd_rn(__fmul_rn(kSmooth, eye0), __fmul_rn(kSmooth, d_mean))
                        : d_mean;
    const float m = nan_max(eye, d_now);
    armed = m > kArm ? true : (eye < kDisarm ? false : armed0);
  }

  // ---- the filter and the tap updates
  float c[kKN];
#pragma unroll
  for (int k = 0; k < kKN; ++k) c[k] = p.c[(size_t)ch * kKN + k];
  const int frames = (!p.autoarm || armed) ? p.f : 0;   // frames to equalize
  for (int fi = frames; fi < p.f; ++fi) {               // an unarmed channel keeps its own
    const size_t at = (base + fi) * kN;
#pragma unroll
    for (int i = 0; i < kN / 32; ++i) p.out[at + lane + 32 * i] = p.frames[at + lane + 32 * i];
  }
  float row[kN / 32], next[kN / 32] = {};
  if (frames) read_row(p.frames + base * kN, lane, row);
  for (int fi = 0; fi < frames; ++fi) {
    const size_t at = (base + fi) * kN;
    if (fi + 1 < frames) read_row(p.frames + at + kN, lane, next);
    stage_row(row, s.xs, lane, win);
#pragma unroll
    for (int i = 0; i < kN / 32; ++i) row[i] = next[i];
    float y[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      float t = __fmul_rn(win[j], c[0]);
#pragma unroll
      for (int k = 1; k < kKN; ++k) t = __fadd_rn(t, __fmul_rn(win[j + k], c[k]));
      y[j] = t;
    }
    if (lane < kLanes) {
      float4* dst = reinterpret_cast<float4*>(p.out + at + kPer * lane);
      dst[0] = make_float4(y[0], y[1], y[2], y[3]);
      dst[1] = make_float4(y[4], y[5], y[6], y[7]);
    }
    if (p.valid[base + fi] == 0) continue;   // the taps adapt on parsed frames only

    // normalize on the sync word (nominal +-3) for the decisions
    double ya[kPer], xd[kPer + 4], dd[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) ya[j] = (double)fabsf(y[j]);
    const double sync = __shfl_sync(kFull, tree8(ya), 0);
    const float scale = clamp_min((float)__ddiv_rn(sync, (double)(3 * kSync)), kFloor);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float yn = __fdiv_rn(y[j], scale);
      float tgt;
      if (lane == 0 && j < kSync) {
        tgt = __fmul_rn((float)((0.0f < yn) - (yn < 0.0f)), 3.0f);
      } else {
        const float mag = fabsf(yn) >= 2.0f ? 3.0f : 1.0f;
        tgt = yn > 0.0f ? mag : -mag;
      }
      dd[j] = (double)__fmul_rn(tgt, scale);
    }
#pragma unroll
    for (int m = 0; m < kPer + 4; ++m) xd[m] = (double)win[m];
    if (lane < kLanes) {                // quantities 0..14: X^T X (k, l), k <= l, row by row
      int q = 0;
#pragma unroll
      for (int k = 0; k < kKN; ++k) {
#pragma unroll
        for (int l = k; l < kKN; ++l, ++q) {
          double pr[kPer];
#pragma unroll
          for (int j = 0; j < kPer; ++j) pr[j] = __dmul_rn(xd[j + k], xd[j + l]);
          s.part[q][lane] = tree8(pr);
        }
      }
#pragma unroll
      for (int k = 0; k < kKN; ++k) {   // quantities 15..19: X^T d
        double pr[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) pr[j] = __dmul_rn(xd[j + k], dd[j]);
        s.part[15 + k][lane] = tree8(pr);
      }
    }
    __syncwarp();
    if (lane < kQ) {                    // quantity `lane`'s 24 leaves, as tree_lanes adds
      double a[12], b[6];
#pragma unroll
      for (int m = 0; m < 12; ++m) a[m] = __dadd_rn(s.part[lane][2 * m], s.part[lane][2 * m + 1]);
#pragma unroll
      for (int m = 0; m < 6; ++m) b[m] = __dadd_rn(a[2 * m], a[2 * m + 1]);
      const double e0 = __dadd_rn(b[0], b[1]), e1 = __dadd_rn(b[2], b[3]);
      const double e2 = __dadd_rn(b[4], b[5]);
      s.tot[lane] = __dadd_rn(__dadd_rn(e0, e1), __dadd_rn(e2, 0.0));
    }
    __syncwarp();
    double a[kKN][kKN], rhs[kKN], x[kKN];
    int q = 0;
#pragma unroll
    for (int k = 0; k < kKN; ++k) {
#pragma unroll
      for (int l = k; l < kKN; ++l, ++q) a[l][k] = l == k ? __dadd_rn(s.tot[q], kLambda) : s.tot[q];
    }
#pragma unroll
    for (int k = 0; k < kKN; ++k) rhs[k] = s.tot[15 + k];
    __syncwarp();                       // tot and part are free for the next frame
    solve5(a, rhs, x);
#pragma unroll
    for (int k = 0; k < kKN; ++k) {
      const float cls = __double2float_rn(x[k]);
      const float cn = __fadd_rn(c[k], __fmul_rn(kMu, __fsub_rn(cls, c[k])));
      c[k] = isfinite(cn) ? cn : c[k];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kKN; ++k) p.c_out[(size_t)ch * kKN + k] = c[k];
    p.eye_out[ch] = eye;
    p.armed_out[ch] = armed ? 1 : 0;
  }
}

}  // namespace

extern "C" int m17_equalize(const float* frames, const uint8_t* valid, const float* c,
                            const float* eye, const uint8_t* armed, float* out, float* c_out,
                            float* eye_out, uint8_t* armed_out, int b, int f, int autoarm,
                            cudaStream_t stream) {
  if (b <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.frames = frames; p.valid = valid; p.c = c; p.eye = eye; p.armed = armed;
  p.out = out; p.c_out = c_out; p.eye_out = eye_out; p.armed_out = armed_out;
  p.b = b; p.f = f; p.autoarm = autoarm != 0;
  const int blocks = (b + kWarps - 1) / kWarps;
  equalize_kernel<<<blocks, kWarps * 32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}
