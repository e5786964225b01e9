// K=5, 16-state soft-decision Viterbi decoder for the M17 convolutional code.
//
// Replaces the TPU kernel m17_sdr_tpu/fec/viterbi_pallas.py:_viterbi_kernel
// (wrapper viterbi_decode_pallas).  Same semantics as the plain version,
// m17_sdr_tpu_torch/fec/viterbi.py:viterbi_decode_ref: terminated trellis
// (state 0 at 0, the other states at -1e6), strict '>' in the compare so
// that ties keep the second predecessor, traceback from state 0, and the
// terminal metric of state 0 returned beside the bits.
//
// Design.  One thread decodes one trellis.  The 16 path metrics live in
// registers and the add-compare-select is fully unrolled: the predecessor
// and branch tables are compile-time functions of the generators, so
// every metric read is a register read.  Each step stores one 16-bit
// survivor word to a time-major [T, N] scratch, so a warp's stores are
// coalesced; the traceback walks that scratch backwards in the same
// kernel.  Branch metrics are +-m1 +-m2 and candidates acm[prev] + bm,
// added in the plain version's order with __fadd_rn, and the file is
// built with --fmad=false: bits and metric match the plain version
// bit for bit.
//
// What bounds it on an H100: not bytes (the soft input is 8 bytes a step,
// the survivor word 2) but the serial dependency through 16 ACS steps per
// trellis step, and the number of trellises in flight: the main path
// decodes B*F trellises per typed decode (12288 at B=4096), about 3 warps
// per SM.  The traceback reads one word per step whose address does not
// depend on the state, so its loads can start ahead of the bit
// extraction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 16;
constexpr int kG1 = 0x13;  // 0b10011
constexpr int kG2 = 0x1D;  // 0b11101

__host__ __device__ constexpr int parity5(int x) {
  return ((x >> 0) ^ (x >> 1) ^ (x >> 2) ^ (x >> 3) ^ (x >> 4)) & 1;
}

// Branch dibit (g1 << 1 | g2) for predecessor w -> next state v.
__host__ __device__ constexpr int branch_dibit(int w, int v) {
  return (parity5((w | ((v >> 3) << 4)) & kG1) << 1) |
         parity5((w | ((v >> 3) << 4)) & kG2);
}

__device__ __forceinline__ float branch(int dibit, float pp, float pm,
                                        float mp, float mm) {
  return dibit == 3 ? pp : dibit == 2 ? pm : dibit == 1 ? mp : mm;
}

__global__ void viterbi_kernel(const float* __restrict__ soft,
                               uint8_t* __restrict__ bits,
                               float* __restrict__ metric,
                               uint16_t* __restrict__ dec, int n, int t_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float2* s = reinterpret_cast<const float2*>(soft + (size_t)i * 2 * t_steps);

  float acm[kStates];
#pragma unroll
  for (int v = 0; v < kStates; ++v) acm[v] = v == 0 ? 0.0f : -1.0e6f;

  for (int t = 0; t < t_steps; ++t) {
    const float2 m = s[t];
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
    dec[(size_t)t * n + i] = (uint16_t)word;
  }
  metric[i] = acm[0];

  int state = 0;
  uint8_t* out = bits + (size_t)i * t_steps;
#pragma unroll 4
  for (int t = t_steps - 1; t >= 0; --t) {
    const unsigned word = dec[(size_t)t * n + i];
    out[t] = (uint8_t)(state >> 3);
    state = ((state & 7) << 1) | ((word >> state) & 1);
  }
}

}  // namespace

extern "C" int m17_viterbi_decode(const float* soft, uint8_t* bits, float* metric,
                                  uint16_t* dec, int n, int t_steps,
                                  cudaStream_t stream) {
  if (n > 0) {
    const int threads = 128;
    viterbi_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
        soft, bits, metric, dec, n, t_steps);
  }
  return (int)cudaGetLastError();
}
