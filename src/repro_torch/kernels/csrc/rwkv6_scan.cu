// RWKV-6 WKV recurrence, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rwkv6_scan.py, `wkv6_pallas` and its Pallas TPU
// kernel `_wkv_kernel`. Same function, per (b, h) with a dk x dv f32 state S:
//     y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
// starting from s0; returns y in r's dtype and S_final in f32. The TPU kernel
// evaluates it in chunked parallel form (pairwise decay ratios from a
// log-cumsum of w); this kernel runs the sequential form, which is the same
// function up to rounding, and so takes any T where the chunked form needs
// T % 64 == 0.
//
// What bounds it on this card: operations. About 5 dk dv f32 operations per
// token and head against 5 (dk or dv) elements read or written; at the RWKV-6
// serving shapes (B 8, H 64, T 1024, dk = dv = 64, bf16) that is 10.7 GFLOP
// (0.16 ms at 67 TFLOP/s) against 0.34 GB (0.10 ms at 3.35 TB/s).
//
// What the design does about it: one block per (b, h), one thread per column
// v of S, which the thread keeps in DK registers for the whole sequence, so
// the state never leaves the SM. The block stages CH tokens of r, k, v and w
// in shared memory at a time (coalesced loads, one barrier pair per chunk
// rather than per token), and computes each token's bonus r_t . (u * k_t),
// which is the same for every column, once. Per token and column the thread
// then does y = sum_i r_i S_i + bonus * v and S_i = w_i S_i + k_i v, reading
// r, k and w from shared memory as broadcasts, four at a time. The TPU's
// sequential chunk axis and VMEM state become the block's loop over T; the
// independent (b, h) pairs become the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int CH = 32;  // tokens staged per chunk

template <typename T, int DK>
__global__ void __launch_bounds__(DK)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_out, int H, int Tlen) {
  __shared__ __align__(16) float sr[CH][DK];
  __shared__ __align__(16) float sk[CH][DK];
  __shared__ __align__(16) float sw[CH][DK];
  __shared__ float sv[CH][DK];
  __shared__ float su[DK];
  __shared__ float bonus[CH];

  const int h = blockIdx.x;
  const int j = threadIdx.x;  // the column of S this thread owns
  const size_t bh = static_cast<size_t>(blockIdx.y) * H + h;
  const size_t seq = bh * Tlen * DK;
  const T* rp = r + seq;
  const T* kp = k + seq;
  const T* vp = v + seq;
  const T* wp = w + seq;
  T* yp = y + seq;

  su[j] = u[static_cast<size_t>(h) * DK + j];
  float s[DK];
  const float* s0p = s0 + bh * DK * DK;
#pragma unroll
  for (int i = 0; i < DK; ++i) s[i] = s0p[i * DK + j];

  for (int t0 = 0; t0 < Tlen; t0 += CH) {
    const int n = min(CH, Tlen - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int idx = j; idx < n * DK; idx += DK) {
      const size_t g = static_cast<size_t>(t0) * DK + idx;
      const int t = idx / DK, i = idx % DK;
      sr[t][i] = repro::to_f32(rp[g]);
      sk[t][i] = repro::to_f32(kp[g]);
      sv[t][i] = repro::to_f32(vp[g]);
      sw[t][i] = repro::to_f32(wp[g]);
    }
    __syncthreads();
    for (int t = j; t < n; t += DK) {
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < DK; ++i) acc = fmaf(sr[t][i] * su[i], sk[t][i], acc);
      bonus[t] = acc;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vv = sv[t][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < DK; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[t][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[t][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[t][i]);
        acc = fmaf(r4.x, s[i], acc);
        acc = fmaf(r4.y, s[i + 1], acc);
        acc = fmaf(r4.z, s[i + 2], acc);
        acc = fmaf(r4.w, s[i + 3], acc);
        s[i] = fmaf(w4.x, s[i], k4.x * vv);
        s[i + 1] = fmaf(w4.y, s[i + 1], k4.y * vv);
        s[i + 2] = fmaf(w4.z, s[i + 2], k4.z * vv);
        s[i + 3] = fmaf(w4.w, s[i + 3], k4.w * vv);
      }
      yp[static_cast<size_t>(t0 + t) * DK + j] = repro::from_f32<T>(fmaf(bonus[t], vv, acc));
    }
  }

  float* sp = s_out + bh * DK * DK;
#pragma unroll
  for (int i = 0; i < DK; ++i) sp[i * DK + j] = s[i];
}

template <typename T, int DK>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const float* u,
                   const float* s0, void* y, float* s_out, int B, int H, int Tlen,
                   cudaStream_t stream) {
  const dim3 grid(H, B);
  wkv6_kernel<T, DK><<<grid, DK, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, s0, static_cast<T*>(y), s_out, H, Tlen);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v, const void* w, const float* u,
                     const float* s0, void* y, float* s_out, int B, int H, int Tlen, int dk,
                     cudaStream_t stream) {
  if (dk == 64) return launch<T, 64>(r, k, v, w, u, s0, y, s_out, B, H, Tlen, stream);
  if (dk == 32) return launch<T, 32>(r, k, v, w, u, s0, y, s_out, B, H, Tlen, stream);
  if (dk == 16) return launch<T, 16>(r, k, v, w, u, s0, y, s_out, B, H, Tlen, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// r, k, v, w, y (B, H, T, d) contiguous, f32 or bf16 when is_bf16, with
// d = dk = dv in {16, 32, 64}; u (H, d) f32; s0 and s_out (B, H, d, d) f32.
// T may be 0 (s_out = s0). Returns the CUDA error of the launch.
extern "C" int repro_wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* s0, void* y, void* s_out, int B, int H,
                              int T, int d, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || T < 0 || B > 65535) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sf = static_cast<float*>(s_out);
  if (is_bf16) return dispatch<__nv_bfloat16>(r, k, v, w, uf, s0f, y, sf, B, H, T, d, s);
  return dispatch<float>(r, k, v, w, uf, s0f, y, sf, B, H, T, d, s);
}
