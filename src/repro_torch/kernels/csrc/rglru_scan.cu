// RG-LRU linear recurrence, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rglru_scan.py, `lru_pallas` and its Pallas TPU
// kernel `_lru_kernel`. Same function: h_t = a_t * h_{t-1} + b_t over
// (B, T, W) with the state in f32, starting from h0 (B, W); returns h_seq in
// a's dtype and h_final in f32.
//
// What bounds it on this card: bytes. Two operations per element against
// reading a and b and writing h once, so the floor is the streaming time of
// those three arrays at device-memory rate (B 8, T 2304, W 2560 in f32:
// about 566 MB, 0.17 ms at 3.35 TB/s).
//
// What the design does about it: the channels are independent, so one thread
// owns one (b, w) channel, keeps h in a register and walks T; neighbouring
// threads hold neighbouring w, so every load of a and b and every store of h
// is coalesced across the warp. The TPU kernel's sequential chunk axis and
// VMEM carry become this loop. Each thread loads UNROLL steps of a and b into
// registers before it runs them, so UNROLL pairs of loads are in flight per
// thread rather than one, since the recurrence itself depends only on h. The
// product and the sum are rounded separately (no fused multiply-add), as the
// plain version rounds them, so the two agree to the bit in f32. Any
// T and any W: the ragged tail of T runs step by step and threads past W
// return, so nothing needs padding or a chunk guard.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS)
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ h_out, int Tlen, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const size_t base = static_cast<size_t>(bi) * Tlen * W + w;
  const T* ap = a + base;
  const T* bp = b + base;
  T* yp = y + base;
  float h = h0[static_cast<size_t>(bi) * W + w];
  int t = 0;
  for (; t + UNROLL <= Tlen; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const size_t off = static_cast<size_t>(t + j) * W;
      av[j] = repro::to_f32(ap[off]);
      bv[j] = repro::to_f32(bp[off]);
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      h = __fadd_rn(__fmul_rn(av[j], h), bv[j]);
      yp[static_cast<size_t>(t + j) * W] = repro::from_f32<T>(h);
    }
  }
  for (; t < Tlen; ++t) {
    const size_t off = static_cast<size_t>(t) * W;
    h = __fadd_rn(__fmul_rn(repro::to_f32(ap[off]), h), repro::to_f32(bp[off]));
    yp[off] = repro::from_f32<T>(h);
  }
  h_out[static_cast<size_t>(bi) * W + w] = h;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, void* y, float* h_out, int B,
                   int Tlen, int W, cudaStream_t stream) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  lru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(a),
                                                   static_cast<const T*>(b), h0,
                                                   static_cast<T*>(y), h_out, Tlen, W);
  return cudaGetLastError();
}

}  // namespace

// a, b, y (B, T, W) contiguous, f32 or bf16 when is_bf16; h0 and h_out (B, W)
// f32. T may be 0 (h_out = h0). Returns the CUDA error of the launch.
extern "C" int repro_lru_scan_fwd(const void* a, const void* b, const void* h0, void* y,
                                  void* h_out, int B, int T, int W, int is_bf16, void* stream) {
  if (B <= 0 || T < 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h_out);
  if (is_bf16) return launch<__nv_bfloat16>(a, b, h0f, y, hf, B, T, W, s);
  return launch<float>(a, b, h0f, y, hf, B, T, W, s);
}
