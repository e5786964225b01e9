// Fused symbol-timing recovery and framer scan over one block.
//
// Replaces the TPU kernel m17_sdr_tpu/frame/receiver_pallas.py:_kernel
// (wrapper receiver_scan_pallas).  The plain version is
// m17_sdr_tpu_torch/frame/receiver.py:receiver_scan_ref, which steps
// _scan_step over a precomputed 80-filter bank; this kernel follows the
// same step, field for field, and must agree with it bit for bit on the
// flags, the slot values and every state field.
//
// Design.  One thread per channel walks the block's S2 steps in order:
// the tap-ordered filter sum is one dependent chain, which cannot be split
// across lanes and stay bit-exact.  A block holds kChannels channels in
// one warp, so the 4096 channels of the main path are 512 blocks, about
// one warp on each of the four schedulers of every SM.  The scan is a chain
// of dependent steps, so a scheduler with one channel group runs it at the
// chain's latency; more channels a warp, or more warps a scheduler, do
// not shorten it.  All 32 lanes stage and write; kChannels lanes scan.
//
// Per chunk of up to kChunk steps (a main-path block of 384 is one):
//  * staging: the 31-sample window and the samples [B, S2] (both taken
//    with their strides; row-major on the main path) are copied with
//    cp.async, neighbouring lanes on neighbouring samples of a row, all
//    copies in flight at once, into shared memory time-major, rows padded
//    to kChannels + 1 floats so that neither the transposing copy nor the
//    scan's reads conflict on banks.  Each lane then rounds what it copied
//    to bf16, once, and writes the raw last 31 samples out as the next
//    window.  The tap banks are copied beside them, 16 bytes at a time;
//  * scan: the loop body is "off steps until the next clk step, then the
//    clk step", so the lanes of a warp, whose clk phases differ, run the
//    31-tap matched and derivative filters together rather than each on
//    its own step.  A clk step issues its 31 shared-memory reads before the
//    dependent add chain; the channel's 2 x 31 taps stay in registers and
//    are re-read from the shared banks only when its phase index moves.
//    The sync correlation runs only under the TPU kernel's gate (hunting,
//    or within +-2 symbols of the frame boundary), and a hunting channel
//    skips it when no sync pattern can pass (see sync_check);
//  * output: slot values and flags go to shared memory, channel-major with
//    an odd row stride, and are written as [B, S2] row-major rows.
//
// Numerics.  Each filter output is the f32 sum, in tap order, of
// f32(bf16(x)) * f32(bf16(h)) -- products of bf16 values are exact in
// f32 -- rounded to bf16: the XLA formulation's numbers.  Rounding a
// sample once at staging gives the values a rounding at every read gave.
// Adds and multiplies are __fadd_rn/__fmul_rn and the file is built with
// --fmad=false, so nothing is contracted.  The sync sums run over the 8
// symbols in order, as frame/sync.py:sync_check does.
//
// What bounds it on an H100: bytes are ~20 MB a block at B=4096 (6 us at
// 3.35 TB/s), operations ~1.5 us; the real floor is the serial chain per
// channel: 192 symbols, each an off step and a clk step whose 31-add
// filter sum and framer update depend on the step before.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPhases = 40;
constexpr int kTaps = 31;
constexpr int kHist = kTaps - 1;  // history samples in front of a block
constexpr int kSync = 8;
constexpr int kTypes = 6;
constexpr int kFrameSymbols = 192;
constexpr int kMaxFrameErrors = 5;
constexpr int kThreshUnlocked = 10;
constexpr int kThreshLocked = 80;
constexpr int kTypeEot = 5;
constexpr int kTypeFirstPayload = 1;  // link (LSF) .. BERT
constexpr int kTypeLastPayload = 4;
constexpr int kUnlockedMaxVotes = 0;
constexpr int kLockedMaxVotes = 1;
constexpr float kUnlockedMaxVariance = 0.3f;
constexpr float kLockedMaxVariance = 0.5f;

constexpr int F_VALID = 1, F_DONE = 2, F_PARSE = 4, F_AOS = 8, F_LOS = 16,
              F_SLIP = 32, F_SLIPFRAME = 64, F_TYPE_SHIFT = 8;

constexpr int kThreads = 32;
constexpr int kChannels = 8;               // channels per block, one lane each
constexpr int kChunk = 384;                // steps per staged chunk
constexpr int kXStride = kChannels + 1;    // time-major staged input row

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Odd output row stride, so the scan lanes' stores hit distinct banks.
__host__ __device__ constexpr int out_stride(int chunk) { return chunk | 1; }

constexpr size_t smem_floats(int chunk) {
  return 2 * kPhases * kTaps + (size_t)(chunk + kHist) * kXStride +
         2 * (size_t)kChannels * out_stride(chunk);
}

// The six sync patterns, passed by value (kernel parameters live in the
// constant bank, so every read below is an instruction operand).  Their
// entries are +-1, which the host entry checks: a product win * pat is
// then exact, so a fused multiply-add rounds as the plain version's
// multiply-then-add does, and the sign agreement of the 8 symbols with a
// pattern is a popcount.  pos: bit i of byte p set where pattern p is +1.
struct Patterns {
  float v[kTypes][kSync];
  unsigned long long pos;
};

struct Sc {
  int ftype;
  bool lok;  // locked gate
  bool uok;  // unlocked (acquisition) gate
};

// frame/sync.py:sync_check followed by locked_pass / unlocked_pass.  A
// hunting channel (!locked) uses only the acquisition gate, which needs a
// payload pattern that no nonzero symbol disagrees with in sign; when no
// pattern qualifies, the gate is closed whatever the correlation says, and
// the correlation is skipped (ftype and lok are read only when locked).
__device__ __forceinline__ Sc sync_check(const float* win, const Patterns& pats, bool locked) {
  unsigned spos = 0, sneg = 0;  // bit i: win[i] > 0, win[i] < 0
#pragma unroll
  for (int i = 0; i < kSync; ++i) {
    spos |= (win[i] > 0.0f ? 1u : 0u) << i;
    sneg |= (win[i] < 0.0f ? 1u : 0u) << i;
  }
  // bit i set where a nonzero symbol's sign disagrees with pattern p
  auto disagree = [&](int p) {
    const unsigned ppos = (unsigned)(pats.pos >> (kSync * p)) & 0xffu;
    return (spos & ~ppos) | (sneg & ppos);
  };
  Sc r = {0, false, false};
  if (!locked) {
    bool open = false;
#pragma unroll
    for (int p = kTypeFirstPayload; p <= kTypeLastPayload; ++p) open |= disagree(p) == 0;
    if (!open) return r;
  }

  int best = 0;
  float bmax = 0.0f;
#pragma unroll
  for (int p = 0; p < kTypes; ++p) {
    // sum_i win[i] * pat[i] in order; each product is exact
    float acc = __fmul_rn(win[0], pats.v[p][0]);
#pragma unroll
    for (int i = 1; i < kSync; ++i) acc = __fmaf_rn(win[i], pats.v[p][i], acc);
    if (p == 0 || acc > bmax) {  // first index of the maximum
      bmax = acc;
      best = p;
    }
  }
  r.ftype = bmax > 0.0f ? best : 0;
  // votes = (nnz - agreement) / 2 with the winning pattern (type 0 when
  // none is positive): the nonzero symbols that disagree with it
  const int votes = __popc(disagree(r.ftype));
  const bool payload = r.ftype >= kTypeFirstPayload && r.ftype <= kTypeLastPayload;
  if (votes <= kLockedMaxVotes && payload) {
    float mmax = fabsf(win[0]), mmin = fabsf(win[0]);
#pragma unroll
    for (int i = 1; i < kSync; ++i) {
      mmax = fmaxf(mmax, fabsf(win[i]));
      mmin = fminf(mmin, fabsf(win[i]));
    }
    const float variance =
        mmax > 0.0f ? __fdiv_rn(__fsub_rn(mmax, mmin), fmaxf(mmax, 1e-30f)) : 1.0f;
    r.lok = variance < kLockedMaxVariance;
    r.uok = votes <= kUnlockedMaxVotes && variance < kUnlockedMaxVariance;
  }
  return r;
}

struct StateIn {
  const int *clk, *thr, *index, *fclk, *ferr, *sync_type;
  const float *mf_sum, *mf_dif, *pending;
  const uint8_t *pending_valid, *flock, *sync_pass, *slip_in_frame;
  const float* sync_win;
};

struct StateOut {
  int *clk, *thr, *index, *fclk, *ferr, *sync_type;
  float *mf_sum, *mf_dif, *pending;
  uint8_t *pending_valid, *flock, *sync_pass, *slip_in_frame;
  float* sync_win;
};

// One channel's carry, and the step of receiver.py:_scan_step.
struct Channel {
  int clk, thr, index, fclk, ferr, sync_type;
  float mf_sum, mf_dif, pending;
  bool pending_valid, flock, sync_pass, slip_in_frame;
  float win[kSync];
  float hm[kTaps], hd[kTaps];  // taps of phase `tap_index`
  int tap_index;

  __device__ bool next_is_clk() const { return (clk + 1) % 2 == 1; }

  // One step; kClk is what next_is_clk() said.  x: the staged input at
  // this step for this channel (row stride kXStride).
  template <bool kClk>
  __device__ __forceinline__ void step(const float* x, const float* h_mf, const float* h_dmf,
                                       const Patterns& pats, float* slot_o, int* flags_o) {
    clk = (clk + 1) % 2;  // == 1 exactly when kClk

    float new_sum = 0.0f;
    if (kClk) {
      if (index != tap_index) {
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          hm[k] = h_mf[index * kTaps + k];
          hd[k] = h_dmf[index * kTaps + k];
        }
        tap_index = index;
      }
      float xv[kTaps];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) xv[k] = x[k * kXStride];
      float acc = __fmul_rn(xv[0], hm[0]);
      float dacc = __fmul_rn(xv[0], hd[0]);
#pragma unroll
      for (int k = 1; k < kTaps; ++k) {
        acc = __fadd_rn(acc, __fmul_rn(xv[k], hm[k]));
        dacc = __fadd_rn(dacc, __fmul_rn(xv[k], hd[k]));
      }
      new_sum = bf16_round(acc);
      mf_sum = new_sum;
      mf_dif = bf16_round(dacc);
    }

    // timing vote on the off-phase
    bool fwd = false, bwd = false;
    if (!kClk) {
      const float dif_signed = mf_sum < 0.0f ? -mf_dif : mf_dif;
      thr += (int)signf(dif_signed);
      const int thresh = flock ? kThreshLocked : kThreshUnlocked;
      fwd = thr > thresh;
      bwd = thr < -thresh;
      if (fwd) index = (index + 1) % kPhases;
      if (bwd) index = (index + kPhases - 1) % kPhases;
      if (fwd || bwd) thr = 0;
    }
    const bool fwd_wrap = fwd && index == 0;
    const bool bwd_wrap = bwd && index == kPhases - 1;
    if (fwd_wrap || bwd_wrap) clk = 1;

    // delayed emission: one (value, valid) slot per step
    const bool emit_now = kClk || fwd_wrap;
    const float slot_val = emit_now ? pending : 0.0f;
    const bool consumed = emit_now && pending_valid;
    if (kClk) pending = new_sum;
    if (fwd_wrap) pending = 0.0f;  // inserted erasure symbol
    pending_valid = (kClk || fwd_wrap || pending_valid) && !bwd_wrap;

    // framer
    const bool flock0 = flock;
    if (consumed) {
#pragma unroll
      for (int i = 0; i < kSync - 1; ++i) win[i] = win[i + 1];
      win[kSync - 1] = slot_val;
      if (flock0) fclk += 1;
    }
    const bool near_boundary = fclk >= kSync - 2 && fclk <= kSync + 2;
    Sc sc = {0, false, false};
    if (consumed && (!flock0 || near_boundary)) sc = sync_check(win, pats, flock0);

    const bool at8 = consumed && flock0 && fclk == kSync;
    if (at8) {
      sync_type = sc.ftype;
      sync_pass = sc.lok;
    }
    const bool resync = consumed && flock0 && sc.uok && !at8 && near_boundary;
    if (resync) {
      fclk = kSync;
      sync_type = sc.ftype;
      sync_pass = true;
    }
    const bool slipped = (slip_in_frame || fwd_wrap || bwd_wrap) && flock0 && !resync;

    const bool frame_done = consumed && flock0 && fclk == kFrameSymbols;
    if (frame_done) fclk = 0;
    const bool is_eot = frame_done && sync_type == kTypeEot;
    const bool good = frame_done && sync_pass && !is_eot;
    const bool bad = frame_done && !sync_pass && !is_eot;
    if (good || resync) ferr = 0;
    else if (bad) ferr += 1;
    const bool too_many = bad && ferr > kMaxFrameErrors;
    const bool los = is_eot || too_many;
    const bool parse = good || (bad && !too_many);

    const bool aos = consumed && !flock0 && sc.uok;
    flock = (flock0 || aos) && !los;
    if (aos) {
      fclk = kSync;
      ferr = 0;
      sync_type = sc.ftype;
      sync_pass = true;
    }
    if (los) {
#pragma unroll
      for (int i = 0; i < kSync; ++i) win[i] = 0.0f;
    }
    slip_in_frame = slipped && !frame_done && !aos;

    *slot_o = slot_val;
    *flags_o = (consumed ? F_VALID : 0) | (frame_done ? F_DONE : 0) |
               (parse ? F_PARSE : 0) | (aos ? F_AOS : 0) | (los ? F_LOS : 0) |
               ((fwd_wrap || bwd_wrap) ? F_SLIP : 0) | (slipped ? F_SLIPFRAME : 0) |
               (sync_type << F_TYPE_SHIFT);
  }
};

__global__ void __launch_bounds__(kThreads)
receiver_scan_kernel(const float* __restrict__ samples, long long ss0, long long ss1,
                     const float* __restrict__ window, long long ws0, long long ws1,
                     const float* __restrict__ taps, const Patterns pats, StateIn in,
                     StateOut out,
                     float* __restrict__ window_out, float* __restrict__ slot_out,
                     int* __restrict__ flags_out, int b, int s2, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* h_mf = smem;                                // [40 * 31]
  float* h_dmf = h_mf + kPhases * kTaps;             // [40 * 31]
  float* xs = h_dmf + kPhases * kTaps;               // [chunk + 30][kXStride]
  const int os = out_stride(chunk);
  float* slot_s = xs + (chunk + kHist) * kXStride;   // [kChannels][os]
  int* flags_s = reinterpret_cast<int*>(slot_s + kChannels * os);

  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kChannels;
  const int nch = min(kChannels, b - c0);
  // both tap banks, 16 bytes a copy (2 * 40 * 31 floats = 620 x 16 B);
  // they land with the first chunk's samples below
  for (int i = lane; i < 2 * kPhases * kTaps / 4; i += kThreads)
    __pipeline_memcpy_async(h_mf + 4 * i, taps + 4 * i, 16);

  const bool scans = lane < nch;
  const int c = c0 + lane;
  Channel ch;
  if (scans) {
    ch.clk = in.clk[c];
    ch.thr = in.thr[c];
    ch.index = in.index[c];
    ch.fclk = in.fclk[c];
    ch.ferr = in.ferr[c];
    ch.sync_type = in.sync_type[c];
    ch.mf_sum = in.mf_sum[c];
    ch.mf_dif = in.mf_dif[c];
    ch.pending = in.pending[c];
    ch.pending_valid = in.pending_valid[c];
    ch.flock = in.flock[c];
    ch.sync_pass = in.sync_pass[c];
    ch.slip_in_frame = in.slip_in_frame[c];
#pragma unroll
    for (int i = 0; i < kSync; ++i) ch.win[i] = in.sync_win[(size_t)c * kSync + i];
    ch.tap_index = -1;
  }

  for (int t0 = 0; t0 < s2; t0 += chunk) {
    const int steps = min(chunk, s2 - t0);
    // stage the history ext[t0, t0 + steps + 30) of the block's channels,
    // where ext = window[:, 1:] ++ samples: every copy in flight at once,
    // then each lane rounds what it copied (keeping the raw values of the
    // next window)
    for (int r = 0; r < nch; ++r) {
      const float* srow = samples + (long long)(c0 + r) * ss0;
      const float* wrow = window + (long long)(c0 + r) * ws0;
      for (int e = lane; e < steps + kHist; e += kThreads) {
        const int g = t0 + e;
        __pipeline_memcpy_async(xs + e * kXStride + r,
                                g < kHist ? wrow + (long long)(g + 1) * ws1
                                          : srow + (long long)(g - kHist) * ss1, 4);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    for (int r = 0; r < nch; ++r) {
      for (int e = lane; e < steps + kHist; e += kThreads) {
        const int g = t0 + e;
        const float val = xs[e * kXStride + r];
        xs[e * kXStride + r] = bf16_round(val);
        if (g >= s2 - 1) window_out[(size_t)(c0 + r) * kTaps + (g - (s2 - 1))] = val;
      }
    }
    __syncthreads();

    if (scans) {
      const float* x = xs + lane;
      float* so = slot_s + lane * os;
      int* fo = flags_s + lane * os;
      int j = 0;
      while (j < steps) {
        while (j < steps && !ch.next_is_clk()) {
          ch.step<false>(x + j * kXStride, h_mf, h_dmf, pats, so + j, fo + j);
          ++j;
        }
        if (j < steps) {
          ch.step<true>(x + j * kXStride, h_mf, h_dmf, pats, so + j, fo + j);
          ++j;
        }
      }
    }
    __syncthreads();

    for (int r = 0; r < nch; ++r) {
      const size_t o = (size_t)(c0 + r) * s2 + t0;
      for (int j = lane; j < steps; j += kThreads) {
        slot_out[o + j] = slot_s[r * os + j];
        flags_out[o + j] = flags_s[r * os + j];
      }
    }
    __syncthreads();
  }

  if (scans) {
    out.clk[c] = ch.clk;
    out.thr[c] = ch.thr;
    out.index[c] = ch.index;
    out.fclk[c] = ch.fclk;
    out.ferr[c] = ch.ferr;
    out.sync_type[c] = ch.sync_type;
    out.mf_sum[c] = ch.mf_sum;
    out.mf_dif[c] = ch.mf_dif;
    out.pending[c] = ch.pending;
    out.pending_valid[c] = ch.pending_valid;
    out.flock[c] = ch.flock;
    out.sync_pass[c] = ch.sync_pass;
    out.slip_in_frame[c] = ch.slip_in_frame;
#pragma unroll
    for (int i = 0; i < kSync; ++i) out.sync_win[(size_t)c * kSync + i] = ch.win[i];
  }
}

}  // namespace

// pats_host: the [6, 8] sync patterns in host memory, every entry +-1.
// Argument order follows m17_sdr_tpu_torch/frame/receiver.py:_KERNEL_FIELDS
// (inputs, then outputs): clk thr index fclk ferr sync_type (int32),
// mf_sum mf_dif pending (f32), pending_valid flock sync_pass slip_in_frame
// (bool as uint8), sync_win ([B, 8] f32).  samples [B, S2] f32 and window
// [B, 31] f32 with their element strides; window_out [B, 31],
// slot [B, S2] f32 and flags [B, S2] i32 row-major.
extern "C" int m17_receiver_scan(
    const float* samples, long long ss0, long long ss1,
    const float* window, long long ws0, long long ws1,
    const float* taps, const float* pats_host,
    const int* clk, const int* thr, const int* index, const int* fclk,
    const int* ferr, const int* sync_type, const float* mf_sum,
    const float* mf_dif, const float* pending, const uint8_t* pending_valid,
    const uint8_t* flock, const uint8_t* sync_pass, const uint8_t* slip_in_frame,
    const float* sync_win,
    int* o_clk, int* o_thr, int* o_index, int* o_fclk, int* o_ferr,
    int* o_sync_type, float* o_mf_sum, float* o_mf_dif, float* o_pending,
    uint8_t* o_pending_valid, uint8_t* o_flock, uint8_t* o_sync_pass,
    uint8_t* o_slip_in_frame, float* o_sync_win,
    float* window_out, float* slot_out, int* flags_out, int b, int s2,
    cudaStream_t stream) {
  if (b <= 0 || s2 <= 0) return 0;
  StateIn in = {clk, thr, index, fclk, ferr, sync_type, mf_sum, mf_dif, pending,
                pending_valid, flock, sync_pass, slip_in_frame, sync_win};
  StateOut out = {o_clk, o_thr, o_index, o_fclk, o_ferr, o_sync_type,
                  o_mf_sum, o_mf_dif, o_pending, o_pending_valid, o_flock,
                  o_sync_pass, o_slip_in_frame, o_sync_win};
  Patterns pats;
  pats.pos = 0;
  for (int p = 0; p < kTypes; ++p) {
    for (int i = 0; i < kSync; ++i) {
      const float v = pats_host[p * kSync + i];
      if (v != 1.0f && v != -1.0f) return (int)cudaErrorInvalidValue;
      pats.v[p][i] = v;
      if (v > 0.0f) pats.pos |= 1ull << (kSync * p + i);
    }
  }
  const int chunk = s2 < kChunk ? s2 : kChunk;
  const size_t smem = smem_floats(chunk) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        receiver_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  receiver_scan_kernel<<<(b + kChannels - 1) / kChannels, kThreads, smem, stream>>>(
      samples, ss0, ss1, window, ws0, ws1, taps, pats, in, out, window_out, slot_out, flags_out,
      b, s2, chunk);
  return (int)cudaGetLastError();
}
