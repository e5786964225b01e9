// K=5, 16-state soft-decision Viterbi decoder for the M17 convolutional code.
//
// Replaces the TPU kernel m17_sdr_tpu/fec/viterbi_pallas.py:_viterbi_kernel
// (wrapper viterbi_decode_pallas).  Same semantics as the plain version,
// m17_sdr_tpu_torch/fec/viterbi.py:viterbi_decode_ref: terminated trellis
// (state 0 at 0, the other states at -1e6), strict '>' in the compare so
// that ties keep the second predecessor, traceback from state 0, and the
// terminal metric of state 0 returned beside the bits.
//
// Design.  One thread decodes one trellis, a block is one warp of 32
// neighbouring rows of the [N, 2T] input, so N = 12288 is 384 blocks, about
// one warp on three of the four schedulers of every SM.  The 16 path metrics
// live in registers and the add-compare-select is fully unrolled: the
// predecessor and branch tables are compile-time functions of the
// generators, and the 16 states of a step are independent, so one warp
// issues its ~100 instructions a step without waiting on their latency.
//  * Input: the warp stages 32 steps of its 32 rows at a time into shared
//    memory, transposed to [step][row] (padded rows), by cp.async: lane l
//    copies step l of every row, so each copy instruction reads 256
//    contiguous bytes of one row.  Two buffers alternate, and the next
//    chunk's copies are in flight while the current one is decoded.
//  * Survivors: one 16-bit word a step, bit v for state v, into a
//    [T][32] buffer in shared memory; the traceback walks it in the same
//    kernel (a word's address does not depend on the state, so the loads
//    run ahead of the bit extraction).
//  * Output: bits go to a shared [32][T] staging area laid out as the
//    block's region of the output, which the warp writes with 16-byte
//    stores (the region starts at blockIdx * 32 * T bytes).
// A state-parallel layout (16 lanes a trellis, shuffles for the
// predecessor metrics, a ballot for the decisions) was built first and
// measured twice as slow: its two shuffles, broadcast load and survivor
// store every step keep the SM's shared-memory pipe busy, where this
// layout makes one shared load and one store a step for 32 trellises.
//
// Numerics: branch metrics are +-m1 +-m2 and candidates acm[prev] + bm,
// added in the plain version's order with __fadd_rn, and the file is built
// with --fmad=false: bits and metric match the plain version bit for bit.
//
// What bounds it on an H100: bytes are 9 per trellis step (26.7 us for a
// block's four decodes at N = 12288) and operations ~68, 10 us; the kernel
// is bound by issuing the ACS instructions on the few warps that 12288
// trellises make.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 16;
constexpr int kG1 = 0x13;  // 0b10011
constexpr int kG2 = 0x1D;  // 0b11101
constexpr int kTrellises = 32;               // one warp a block, one trellis a lane
constexpr int kChunk = 32;                   // steps a staged input chunk: one a lane
constexpr int kInStride = kTrellises + 1;    // float2 a staged step row
static_assert(kChunk == kTrellises, "a lane stages one step of a chunk");

__host__ __device__ constexpr int parity5(int x) {
  return ((x >> 0) ^ (x >> 1) ^ (x >> 2) ^ (x >> 3) ^ (x >> 4)) & 1;
}

// Branch dibit (g1 << 1 | g2) for predecessor w -> next state v.
__host__ __device__ constexpr int branch_dibit(int w, int v) {
  return (parity5((w | ((v >> 3) << 4)) & kG1) << 1) |
         parity5((w | ((v >> 3) << 4)) & kG2);
}

__device__ __forceinline__ float branch(int dibit, float pp, float pm, float mp, float mm) {
  return dibit == 3 ? pp : dibit == 2 ? pm : dibit == 1 ? mp : mm;
}

constexpr size_t smem_bytes(int t_steps) {
  return sizeof(float2) * 2 * kChunk * kInStride      // input chunks
         + sizeof(uint16_t) * kTrellises * t_steps    // survivor words [T][32]
         + (size_t)kTrellises * t_steps;              // staged output bits [32][T]
}

__global__ void __launch_bounds__(kTrellises)
viterbi_kernel(const float* __restrict__ soft, uint8_t* __restrict__ bits,
               float* __restrict__ metric, int n, int t_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* in = reinterpret_cast<float2*>(smem);
  uint16_t* dec = reinterpret_cast<uint16_t*>(in + 2 * kChunk * kInStride);
  uint8_t* out_bits = reinterpret_cast<uint8_t*>(dec + kTrellises * t_steps);

  const int lane = threadIdx.x;
  const int first = blockIdx.x * kTrellises;   // the block's first trellis
  const int rows = min(kTrellises, n - first);
  const float2* src = reinterpret_cast<const float2*>(soft) + (size_t)first * t_steps;
  const int nchunks = (t_steps + kChunk - 1) / kChunk;

  // chunk k into buffer k & 1: this lane copies step k * kChunk + lane of every row
  auto stage = [&](int k) {
    float2* buf = in + (k & 1) * kChunk * kInStride + lane * kInStride;
    const int t = k * kChunk + lane;
    if (t < t_steps) {
      for (int r = 0; r < rows; ++r)
        __pipeline_memcpy_async(buf + r, src + (size_t)r * t_steps + t, sizeof(float2));
    }
    __pipeline_commit();
  };

  float acm[kStates];
#pragma unroll
  for (int v = 0; v < kStates; ++v) acm[v] = v == 0 ? 0.0f : -1.0e6f;

  stage(0);
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) stage(k + 1);
    else __pipeline_commit();        // an empty group keeps the count below
    __pipeline_wait_prior(1);        // chunk k has landed
    __syncwarp();
    const float2* buf = in + (k & 1) * kChunk * kInStride + lane;
    const int t0 = k * kChunk;
    const int steps = min(kChunk, t_steps - t0);
    float2 m = buf[0];
#pragma unroll 2
    for (int j = 0; j < steps; ++j) {
      const float2 m_next = buf[min(j + 1, steps - 1) * kInStride];
      // s1*m1 + s2*m2 with s = +-1: the products are exact, one rounding
      const float pp = __fadd_rn(m.x, m.y);
      const float pm = __fadd_rn(m.x, -m.y);
      const float mp = __fadd_rn(-m.x, m.y);
      const float mm = __fadd_rn(-m.x, -m.y);
      float nxt[kStates];
      unsigned word = 0;
#pragma unroll
      for (int v = 0; v < kStates; ++v) {
        const int w0 = (v & 7) << 1;
        const int w1 = w0 + 1;
        const float c0 = __fadd_rn(acm[w0], branch(branch_dibit(w0, v), pp, pm, mp, mm));
        const float c1 = __fadd_rn(acm[w1], branch(branch_dibit(w1, v), pp, pm, mp, mm));
        const bool take0 = c0 > c1;  // strict: ties keep the second predecessor
        nxt[v] = take0 ? c0 : c1;
        word |= take0 ? 0u : (1u << v);
      }
#pragma unroll
      for (int v = 0; v < kStates; ++v) acm[v] = nxt[v];
      dec[(t0 + j) * kTrellises + lane] = (uint16_t)word;
      m = m_next;
    }
    __syncwarp();                    // buffer k & 1 is refilled by stage(k + 2)
  }

  if (lane < rows) {
    metric[first + lane] = acm[0];
    uint8_t* out = out_bits + lane * t_steps;
    int state = 0;
#pragma unroll 8
    for (int t = t_steps - 1; t >= 0; --t) {
      const unsigned word = dec[t * kTrellises + lane];
      out[t] = (uint8_t)(state >> 3);
      state = ((state & 7) << 1) | ((word >> state) & 1);
    }
  }
  __syncwarp();

  // the block's rows of bits are one contiguous region of the output
  const size_t len = (size_t)rows * t_steps;
  uint8_t* dst = bits + (size_t)first * t_steps;
  size_t done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    done = len / 16 * 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(out_bits);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (size_t q = lane; q < len / 16; q += kTrellises) d4[q] = s4[q];
  }
  for (size_t q = done + lane; q < len; q += kTrellises) dst[q] = out_bits[q];
}

}  // namespace

// soft [n, 2T] f32, bits [n, T] u8, metric [n] f32, on `stream`.
extern "C" int m17_viterbi_decode(const float* soft, uint8_t* bits, float* metric,
                                  int n, int t_steps, cudaStream_t stream) {
  if (n <= 0) return 0;
  const size_t smem = smem_bytes(t_steps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  viterbi_kernel<<<(n + kTrellises - 1) / kTrellises, kTrellises, smem, stream>>>(
      soft, bits, metric, n, t_steps);
  return (int)cudaGetLastError();
}
