// Fused symbol-timing recovery and framer scan over one block.
//
// Replaces the TPU kernel m17_sdr_tpu/frame/receiver_pallas.py:_kernel
// (wrapper receiver_scan_pallas).  The plain version is
// m17_sdr_tpu_torch/frame/receiver.py:receiver_scan_ref, which steps
// _scan_step over a precomputed 80-filter bank; this kernel follows the
// same step, field for field, and must agree with it bit for bit on the
// flags, the slot values and every state field.
//
// Design.  One thread per channel walks the block's S2 steps in order;
// the timing loop, the framer state machine and the 8-symbol sync window
// live in registers.  The input is time-major, ext[S2+30][B], so a warp's
// loads at one step are neighbouring addresses.  Both 40 x 31 tap banks
// (already rounded to bf16 by the wrapper) sit in shared memory, and a
// thread reads its own phase's row: the matched and derivative filters
// are evaluated only at the channel's clk steps and only at its current
// phase, 62 products instead of the plain version's 80 x 31.  The sync
// correlation runs only when its result can be used (hunting, or within
// +-2 symbols of the frame boundary), as in the TPU kernel.
//
// Numerics.  Each filter output is the f32 sum, in tap order, of
// f32(bf16(ext)) * f32(bf16(h)) -- products of bf16 values are exact in
// f32 -- rounded to bf16: the XLA formulation's numbers.  Adds and
// multiplies are __fadd_rn/__fmul_rn and the file is built with
// --fmad=false, so nothing is contracted.  The sync sums run over the 8
// symbols in order, as frame/sync.py:sync_check does.
//
// What bounds it on an H100: the scan is sequential in time, so the
// parallelism is the channel count.  At B = 4096 that is 4096 threads,
// 128 warps over 132 SMs: one warp per SM, which leaves the SMs mostly
// waiting on the latency of each step's dependent loads and branches.
// Bytes are small (ext is read once per step from L1/L2; the outputs are
// 8 bytes per channel-step).  Spreading one channel's work over more
// threads is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPhases = 40;
constexpr int kTaps = 31;
constexpr int kSync = 8;
constexpr int kTypes = 6;
constexpr int kFrameSymbols = 192;
constexpr int kMaxFrameErrors = 5;
constexpr int kThreshUnlocked = 10;
constexpr int kThreshLocked = 80;
constexpr int kTypeEot = 5;
constexpr int kUnlockedMaxVotes = 0;
constexpr int kLockedMaxVotes = 1;
constexpr float kUnlockedMaxVariance = 0.3f;
constexpr float kLockedMaxVariance = 0.5f;

constexpr int F_VALID = 1, F_DONE = 2, F_PARSE = 4, F_AOS = 8, F_LOS = 16,
              F_SLIP = 32, F_SLIPFRAME = 64, F_TYPE_SHIFT = 8;

constexpr int kThreads = 32;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

struct Sc {
  int ftype;
  bool lok;  // locked gate
  bool uok;  // unlocked (acquisition) gate
};

// frame/sync.py:sync_check followed by locked_pass / unlocked_pass
__device__ Sc sync_check(const float* win, const float (*pats)[kSync]) {
  float s[kSync];
#pragma unroll
  for (int i = 0; i < kSync; ++i) s[i] = signf(win[i]);
  int best = 0;
  float bmax = 0.0f, agree_best = 0.0f;
#pragma unroll
  for (int p = 0; p < kTypes; ++p) {
    float acc = __fmul_rn(win[0], pats[p][0]);
    float sacc = __fmul_rn(s[0], pats[p][0]);
#pragma unroll
    for (int i = 1; i < kSync; ++i) {
      acc = __fadd_rn(acc, __fmul_rn(win[i], pats[p][i]));
      sacc = __fadd_rn(sacc, __fmul_rn(s[i], pats[p][i]));
    }
    if (p == 0 || acc > bmax) {  // first index of the maximum
      bmax = acc;
      best = p;
      agree_best = sacc;
    }
  }
  Sc r;
  r.ftype = bmax > 0.0f ? best : 0;
  if (r.ftype != best) {  // type 0 wins by default: its agreement count
    float sacc = __fmul_rn(s[0], pats[0][0]);
#pragma unroll
    for (int i = 1; i < kSync; ++i) sacc = __fadd_rn(sacc, __fmul_rn(s[i], pats[0][i]));
    agree_best = sacc;
  }
  float nnz = fabsf(s[0]);
  float mmax = fabsf(win[0]), mmin = fabsf(win[0]);
#pragma unroll
  for (int i = 1; i < kSync; ++i) {
    nnz = __fadd_rn(nnz, fabsf(s[i]));
    mmax = fmaxf(mmax, fabsf(win[i]));
    mmin = fminf(mmin, fabsf(win[i]));
  }
  const int votes = (int)__fmul_rn(__fsub_rn(nnz, agree_best), 0.5f);
  const float variance =
      mmax > 0.0f ? __fdiv_rn(__fsub_rn(mmax, mmin), fmaxf(mmax, 1e-30f)) : 1.0f;
  const bool payload = r.ftype >= 1 && r.ftype <= 4;
  r.lok = votes <= kLockedMaxVotes && payload && variance < kLockedMaxVariance;
  r.uok = votes <= kUnlockedMaxVotes && payload && variance < kUnlockedMaxVariance;
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

__global__ void __launch_bounds__(kThreads)
receiver_scan_kernel(const float* __restrict__ ext, const float* __restrict__ taps,
                     const float* __restrict__ pats_g, StateIn in, StateOut out,
                     float* __restrict__ slot_out, int* __restrict__ flags_out,
                     int b, int s2) {
  __shared__ float h_mf[kPhases][kTaps];
  __shared__ float h_dmf[kPhases][kTaps];
  __shared__ float pats[kTypes][kSync];
  for (int i = threadIdx.x; i < kPhases * kTaps; i += blockDim.x) {
    h_mf[i / kTaps][i % kTaps] = taps[i];
    h_dmf[i / kTaps][i % kTaps] = taps[kPhases * kTaps + i];
  }
  for (int i = threadIdx.x; i < kTypes * kSync; i += blockDim.x)
    pats[i / kSync][i % kSync] = pats_g[i];
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= b) return;

  int clk = in.clk[c], thr = in.thr[c], index = in.index[c];
  int fclk = in.fclk[c], ferr = in.ferr[c], sync_type = in.sync_type[c];
  float mf_sum = in.mf_sum[c], mf_dif = in.mf_dif[c], pending = in.pending[c];
  bool pending_valid = in.pending_valid[c], flock = in.flock[c];
  bool sync_pass = in.sync_pass[c], slip_in_frame = in.slip_in_frame[c];
  float win[kSync];
#pragma unroll
  for (int i = 0; i < kSync; ++i) win[i] = in.sync_win[(size_t)c * kSync + i];

  for (int t = 0; t < s2; ++t) {
    clk = (clk + 1) % 2;
    const bool is_clk = clk == 1;

    // matched + derivative filter at the current phase, clk steps only
    float new_sum = 0.0f;
    if (is_clk) {
      const float* x = ext + (size_t)t * b + c;
      float x0 = bf16_round(x[0]);
      float acc = __fmul_rn(x0, h_mf[index][0]);
      float dacc = __fmul_rn(x0, h_dmf[index][0]);
#pragma unroll
      for (int k = 1; k < kTaps; ++k) {
        const float xk = bf16_round(x[(size_t)k * b]);
        acc = __fadd_rn(acc, __fmul_rn(xk, h_mf[index][k]));
        dacc = __fadd_rn(dacc, __fmul_rn(xk, h_dmf[index][k]));
      }
      new_sum = bf16_round(acc);
      mf_sum = new_sum;
      mf_dif = bf16_round(dacc);
    }

    // timing vote on the off-phase
    const float dif_signed = mf_sum < 0.0f ? -mf_dif : mf_dif;
    if (!is_clk) thr += (int)signf(dif_signed);
    const int thresh = flock ? kThreshLocked : kThreshUnlocked;
    const bool fwd = !is_clk && thr > thresh;
    const bool bwd = !is_clk && thr < -thresh;
    if (fwd) index = (index + 1) % kPhases;
    if (bwd) index = (index + kPhases - 1) % kPhases;
    if (fwd || bwd) thr = 0;
    const bool fwd_wrap = fwd && index == 0;
    const bool bwd_wrap = bwd && index == kPhases - 1;
    if (fwd_wrap || bwd_wrap) clk = 1;

    // delayed emission: one (value, valid) slot per step
    const bool emit_now = is_clk || fwd_wrap;
    const float slot_val = emit_now ? pending : 0.0f;
    const bool consumed = emit_now && pending_valid;
    if (is_clk) pending = new_sum;
    if (fwd_wrap) pending = 0.0f;  // inserted erasure symbol
    pending_valid = (is_clk || fwd_wrap || pending_valid) && !bwd_wrap;

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
    if (consumed && (!flock0 || near_boundary)) sc = sync_check(win, pats);

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

    const size_t o = (size_t)t * b + c;
    slot_out[o] = slot_val;
    flags_out[o] = (consumed ? F_VALID : 0) | (frame_done ? F_DONE : 0) |
                   (parse ? F_PARSE : 0) | (aos ? F_AOS : 0) | (los ? F_LOS : 0) |
                   ((fwd_wrap || bwd_wrap) ? F_SLIP : 0) |
                   (slipped ? F_SLIPFRAME : 0) | (sync_type << F_TYPE_SHIFT);
  }

  out.clk[c] = clk;
  out.thr[c] = thr;
  out.index[c] = index;
  out.fclk[c] = fclk;
  out.ferr[c] = ferr;
  out.sync_type[c] = sync_type;
  out.mf_sum[c] = mf_sum;
  out.mf_dif[c] = mf_dif;
  out.pending[c] = pending;
  out.pending_valid[c] = pending_valid;
  out.flock[c] = flock;
  out.sync_pass[c] = sync_pass;
  out.slip_in_frame[c] = slip_in_frame;
#pragma unroll
  for (int i = 0; i < kSync; ++i) out.sync_win[(size_t)c * kSync + i] = win[i];
}

}  // namespace

// Argument order follows m17_sdr_tpu_torch/frame/receiver.py:_KERNEL_FIELDS
// (inputs, then outputs): clk thr index fclk ferr sync_type (int32),
// mf_sum mf_dif pending (f32), pending_valid flock sync_pass slip_in_frame
// (bool as uint8), sync_win ([B, 8] f32).
extern "C" int m17_receiver_scan(
    const float* ext, const float* taps, const float* pats,
    const int* clk, const int* thr, const int* index, const int* fclk,
    const int* ferr, const int* sync_type, const float* mf_sum,
    const float* mf_dif, const float* pending, const uint8_t* pending_valid,
    const uint8_t* flock, const uint8_t* sync_pass, const uint8_t* slip_in_frame,
    const float* sync_win,
    int* o_clk, int* o_thr, int* o_index, int* o_fclk, int* o_ferr,
    int* o_sync_type, float* o_mf_sum, float* o_mf_dif, float* o_pending,
    uint8_t* o_pending_valid, uint8_t* o_flock, uint8_t* o_sync_pass,
    uint8_t* o_slip_in_frame, float* o_sync_win,
    float* slot_out, int* flags_out, int b, int s2, cudaStream_t stream) {
  StateIn in = {clk, thr, index, fclk, ferr, sync_type, mf_sum, mf_dif, pending,
                pending_valid, flock, sync_pass, slip_in_frame, sync_win};
  StateOut out = {o_clk, o_thr, o_index, o_fclk, o_ferr, o_sync_type,
                  o_mf_sum, o_mf_dif, o_pending, o_pending_valid, o_flock,
                  o_sync_pass, o_slip_in_frame, o_sync_win};
  if (b > 0) {
    receiver_scan_kernel<<<(b + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        ext, taps, pats, in, out, slot_out, flags_out, b, s2);
  }
  return (int)cudaGetLastError();
}
