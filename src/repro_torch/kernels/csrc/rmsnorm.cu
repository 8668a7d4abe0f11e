// Row-wise RMSNorm, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py, `rmsnorm_pallas` and its Pallas TPU
// kernel `_rmsnorm_kernel`. Same function: y = x * rsqrt(mean(x^2) + eps) * w
// over the last axis, moments in f32, y in x's dtype.
//
// What bounds it on this card: bytes. It does about 4 operations per element
// it reads, far below the card's ratio of operations to memory bandwidth, so
// reading x once and writing y once at device-memory rate is the floor.
//
// What the design does about it: one pass over each row with coalesced
// loads, the sum of squares reduced in registers with warp shuffles, and the
// second read of the row served from L1/L2 rather than device memory. Rows of
// up to 1024 elements get one warp each (8 rows per block), so the 8-row
// decode batch and the 4096-row prefill batch both fill the card without a
// shared-memory reduction; wider rows (up to 12288) get a block of 256
// threads each. The weight arrives as f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int WARP_ROWS_MAX_D = 1024;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_warp_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
                    long long rows, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  float ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float a = repro::to_f32(xr[c]);
    ss = fmaf(a, a, ss);
  }
  ss = repro::segment_sum<32>(ss);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  for (int c = lane; c < D; c += 32) yr[c] = repro::from_f32<T>(repro::to_f32(xr[c]) * r * w[c]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_block_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
                     int D, float eps) {
  __shared__ float partial[THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const T* xr = x + static_cast<long long>(blockIdx.x) * D;
  T* yr = y + static_cast<long long>(blockIdx.x) * D;
  float ss = 0.f;
  for (int c = threadIdx.x; c < D; c += THREADS) {
    const float a = repro::to_f32(xr[c]);
    ss = fmaf(a, a, ss);
  }
  ss = repro::segment_sum<32>(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < THREADS / 32 ? partial[lane] : 0.f;
    ss = repro::segment_sum<32>(ss);
    if (lane == 0) partial[0] = ss;
  }
  __syncthreads();
  const float r = rsqrtf(partial[0] / static_cast<float>(D) + eps);
  for (int c = threadIdx.x; c < D; c += THREADS)
    yr[c] = repro::from_f32<T>(repro::to_f32(xr[c]) * r * w[c]);
}

template <typename T>
cudaError_t launch(const void* x, const float* w, void* y, long long rows, int D, float eps,
                   cudaStream_t stream) {
  if (D <= WARP_ROWS_MAX_D) {
    const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
    rmsnorm_warp_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(y), rows, D, eps);
  } else {
    rmsnorm_block_kernel<T><<<static_cast<unsigned>(rows), THREADS, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(y), D, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x and y (rows, D) contiguous, f32 or bf16 when is_bf16; w (D,) f32.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int repro_rmsnorm_fwd(const void* x, const void* w, void* y, long long rows, int D,
                                 int is_bf16, float eps, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || D <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (is_bf16) return launch<__nv_bfloat16>(x, wf, y, rows, D, eps, s);
  return launch<float>(x, wf, y, rows, D, eps, s);
}
