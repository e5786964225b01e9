// The frame compaction of one receive_block call (K5): the receiver scan's
// slot values [B, S2] f32 and flags [B, S2] i32 and the carried 191-symbol
// history [B, 191] f32 in; the frames [B, F, 192] f32, their four masks
// [B, F], the block's aos, los and slip count [B] and the rolled history
// [B, 191] out, in one launch.
//
// Replaces no TPU kernel.  The JAX package compacts with XLA's sort and
// gathers after the Pallas scan (m17_sdr_tpu/frame/receiver.py:receive_block);
// the port's plain version, m17_sdr_tpu_torch/frame/receiver.py:compact_ref,
// does the same in about 50 eager launches: a stable argsort of the invalid
// mask to put the valid slots first, a sort of the completion positions to
// pick the first F, and gathers.  Both sorts do index work that a prefix
// count does: a valid step's compact index is the number of valid steps up
// to it, a completion's frame slot the number of completions before it.
// This kernel must agree with the plain version bit for bit on every
// output, including the slots no frame completed in (the typed decodes
// read them all).
//
// What bounds it on an H100: bytes.  At [4096, 4992] (F = 15) the slot
// values and flags are 164 MB in, the frames 47 MB out, the rest 6.5 MB:
// 217.5 MB, 65 us at 3.35 TB/s.  A step costs a few integer operations.
//
// Design.  One block of 256 threads a channel.  The block walks the row in
// tiles of 1024 steps, each thread loading 4 consecutive flags and slot
// values (16-byte loads where the row allows), and a block-wide scan of
// each thread's (valid, completion) counts gives every valid step its
// place in the symbol stream "history ++ valid slot values" and every
// completion its rank.  The stream is staged in shared memory (in a global
// scratch the wrapper allocates, where a row does not fit the 48 KB a
// block gets without asking); the first F completions write their frame
// slot's type, parse and slip flags and its start in the stream.  Then the
// frames and the new history are written, coalesced, from the stream.
//
// Which stream positions are read: a frame completed where vc valid steps
// had been seen starts at max(vc - 1, 0) and ends at max(vc - 1, 0) + 191,
// so with vc >= 1 it ends on the vc-th valid slot value; the history reads
// up to the last valid one.  Only vc = 0 in a block with no valid step reads
// past the valid slots, one value: the plain version's stable argsort then
// leaves step 0 first, so position 191 holds slot value 0.  A frame slot
// with no completion takes step S2 - 1's type and vc = the block's valid
// count, as the plain version's clamp of the sort's padding does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHist = 191;              // symbols carried across blocks
constexpr int kN = 192;                 // symbols a frame
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                 // consecutive steps a thread takes in a tile
constexpr int kTile = kThreads * kPer;
constexpr unsigned kFull = 0xffffffffu;

constexpr int F_VALID = 1, F_DONE = 2, F_PARSE = 4, F_AOS = 8, F_LOS = 16,
              F_SLIP = 32, F_SLIPFRAME = 64, F_TYPE_SHIFT = 8;

struct Params {
  const float* slot;
  const int* flags;
  const float* hist;
  float* frames;
  uint8_t* valid;
  uint8_t* parse;
  uint8_t* slipped;
  int* type;
  uint8_t* aos;
  uint8_t* los;
  int* n_slips;
  float* hist_out;
  float* scratch;                       // null: the stream in shared memory
  int s2, f, vec;
};

// Loads steps t .. t + 3 of a row; steps past the row read as no event.
__device__ __forceinline__ void load_steps(const Params& p, const int* flags, const float* slot,
                                           int t, int fl[kPer], float v[kPer]) {
  if (p.vec && t < p.s2) {
    const int4 a = *reinterpret_cast<const int4*>(flags + t);
    const float4 b = *reinterpret_cast<const float4*>(slot + t);
    fl[0] = a.x; fl[1] = a.y; fl[2] = a.z; fl[3] = a.w;
    v[0] = b.x; v[1] = b.y; v[2] = b.z; v[3] = b.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const bool in = t + k < p.s2;
    fl[k] = in ? flags[t + k] : 0;
    v[k] = in ? slot[t + k] : 0.0f;
  }
}

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads) compact_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ unsigned warp_sums[2][kWarps];
  __shared__ int warp_slips[kWarps];

  const int ch = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s2 = p.s2, f = p.f;
  const size_t row = (size_t)ch * s2;
  const int* flags = p.flags + row;
  const float* slot = p.slot + row;
  float* stream = p.scratch ? p.scratch + (size_t)ch * (kHist + s2 + f) : smem;
  int* starts = reinterpret_cast<int*>(stream + kHist + s2);
  const size_t fbase = (size_t)ch * f;

  for (int i = tid; i < kHist; i += kThreads) stream[i] = p.hist[(size_t)ch * kHist + i];

  // counts of the tiles before: valid steps and frame completions
  unsigned vbase = 0, dbase = 0;
  int events = 0, slips = 0;
  int fl[kPer];
  float v[kPer];
  load_steps(p, flags, slot, tid * kPer, fl, v);
  for (int t0 = 0, tile = 0; t0 < s2; t0 += kTile, ++tile) {
    int cur[kPer];
    float val[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) { cur[k] = fl[k]; val[k] = v[k]; }
    if (t0 + kTile < s2) load_steps(p, flags, slot, t0 + kTile + tid * kPer, fl, v);

    unsigned nv = 0, nd = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      nv += (cur[k] & F_VALID) != 0;
      nd += (cur[k] & F_DONE) != 0;
      slips += (cur[k] & F_SLIP) != 0;
      events |= cur[k];
    }
    // both counts in one scan: at most 1024 of each in a tile
    const unsigned x = nv | (nd << 16);
    const unsigned inc = warp_inclusive_scan(x, lane);
    unsigned* sums = warp_sums[tile & 1];   // two buffers: one barrier a tile
    if (lane == 31) sums[warp] = inc;
    __syncthreads();
    unsigned before = inc - x, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned s = sums[w];
      before += w < warp ? s : 0u;
      total += s;
    }
    unsigned vc = vbase + (before & 0xffffu), dc = dbase + (before >> 16);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (cur[k] & F_VALID) stream[kHist + vc++] = val[k];
      if (cur[k] & F_DONE) {
        if (dc < (unsigned)f) {
          p.valid[fbase + dc] = 1;
          p.parse[fbase + dc] = (cur[k] & F_PARSE) != 0;
          p.slipped[fbase + dc] = (cur[k] & F_SLIPFRAME) != 0;
          p.type[fbase + dc] = cur[k] >> F_TYPE_SHIFT;
          starts[dc] = vc > 0 ? (int)vc - 1 : 0;
        }
        ++dc;
      }
    }
    vbase += total & 0xffffu;
    dbase += total >> 16;
  }

  // the frame slots no completion filled: step S2 - 1 and the block's count
  const int last_type = flags[s2 - 1] >> F_TYPE_SHIFT;
  for (unsigned r = dbase + tid; r < (unsigned)f; r += kThreads) {
    p.valid[fbase + r] = 0;
    p.parse[fbase + r] = 0;
    p.slipped[fbase + r] = 0;
    p.type[fbase + r] = last_type;
    starts[r] = vbase > 0 ? (int)vbase - 1 : 0;
  }
  if (tid == 0 && vbase == 0) stream[kHist] = slot[0];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) slips += __shfl_xor_sync(kFull, slips, d);
  if (lane == 0) warp_slips[warp] = slips;
  // barriers: the stream, the starts and the warps' slip counts are in place
  const int aos = __syncthreads_or(events & F_AOS);
  const int los = __syncthreads_or(events & F_LOS);
  if (tid == 0) {
    int n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) n += warp_slips[w];
    p.aos[ch] = aos != 0;
    p.los[ch] = los != 0;
    p.n_slips[ch] = n;
  }

  // the frames: a warp's 32 symbols lie in one frame (32 divides 192)
  float* out = p.frames + fbase * kN;
  for (int e = tid; e < f * kN; e += kThreads) {
    const int fr = e / kN;
    out[e] = stream[starts[fr] + e - fr * kN];
  }
  for (int i = tid; i < kHist; i += kThreads)
    p.hist_out[(size_t)ch * kHist + i] = stream[vbase + i];
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 where b is 0).  The outputs
// are written whole; scratch is null or [b, 191 + s2 + f] floats.
extern "C" int m17_compact(const float* slot, const int* flags, const float* hist,
                           float* frames, uint8_t* valid, uint8_t* parse, uint8_t* slipped,
                           int* type, uint8_t* aos, uint8_t* los, int* n_slips,
                           float* hist_out, float* scratch, int b, int s2, int f,
                           cudaStream_t stream) {
  if (b <= 0) return 0;
  if (s2 <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = s2 % kPer == 0 && reinterpret_cast<uintptr_t>(slot) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(flags) % 16 == 0;
  Params p = {slot, flags, hist, frames, valid, parse, slipped, type, aos, los, n_slips,
              hist_out, scratch, s2, f, vec ? 1 : 0};
  const size_t smem = scratch ? 0 : (size_t)(kHist + s2 + f) * sizeof(float);
  compact_kernel<<<b, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
