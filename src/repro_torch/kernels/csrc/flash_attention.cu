// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, `flash_attention` and its
// Pallas TPU kernel `_attn_kernel`. Same function: softmax(q k^T * d^-0.5)
// v with an online softmax over KV tiles, f32 running max m, sum l and
// accumulator acc, optional causal mask, sliding window and tanh logit cap,
// GQA through the KV head h / G, output acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on this card: operations. At the serving shapes of nbi-100m
// (B 8, H 12, S 512, d 64, causal, f32) one call needs about 3.2 GFLOP of
// matrix products against about 50 MB of q, k, v and o, so the f32 rate
// (no tensor cores for f32) and not device memory is the limit.
//
// What the design does about it: the S x S score matrix never reaches device
// memory, and tiles that the causal or window bound masks completely are never
// loaded or computed (the same tests as `_attn_kernel`), which halves the work
// of a causal prefill. One block of 256 threads owns one (b, hq, 64-row query
// tile) and loops over 64-key tiles; that loop replaces the TPU's sequential
// `ki` grid axis, since blocks on Hopper share no scratch. Q, K, V and P tiles
// live in shared memory as f32 (padded rows avoid bank conflicts); each thread
// keeps a 4x4 block of scores and a 4 x (dv/16) block of acc in registers, so
// one shared-memory load feeds several FMAs. The four rows of a thread are
// owned by the 16 lanes of a half-warp, so row max and row sum are warp
// shuffles and P needs only a warp barrier. p stays f32 for the PV product, as
// in the Pallas kernel. bf16 inputs are widened to f32 on load. This first
// version runs on the f32 FMA units; wgmma, TMA and warp specialisation are
// later work. Ragged Sq and Skv are masked in the kernel, so nothing is padded
// in device memory.
//
// Head dims: (64, 64), (128, 128), the two mixed pairs, and (256, 256) for
// Griffin's local attention. At d 256 the f32 tiles take 213,760 bytes of
// shared memory (Q and K 64 x 257, V 64 x 256, P 64 x 65 floats), under the
// 232,448 a block may opt into, so one block runs per SM; each thread then
// holds 4 x 16 accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr float NEG_INF = -1e30f;

template <int D, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * DV + BQ * (BK + 1));
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                      int Sq, int Skv, float scale, int causal, int window,
                      float logit_cap) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][D + 1], pre-scaled
  float* Ks = Qs + BQ * (D + 1);    // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);    // [BK][DV]
  float* Ps = Vs + BK * DV;         // [BQ][BK + 1]

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tr = tid / 16;  // rows tr*4 .. tr*4+3 of the tile
  const int tc = tid % 16;  // score columns and output columns tc + 16*j

  const T* qb = q + (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Skv * DV;
  T* ob = o + (static_cast<size_t>(b) * Hq + h) * Sq * DV;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, row = q_start + r;
    Qs[r * (D + 1) + c] = row < Sq ? repro::to_f32(qb[static_cast<size_t>(row) * D + c]) * scale : 0.f;
  }

  constexpr int NC = DV / 16;
  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_k = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k_start = kt * BK;
    // Tile liveness, as in _attn_kernel: causal kills tiles right of the
    // tile's last row (and every later tile); the window kills tiles left of
    // its first row's reach. Both tests are uniform over the block.
    if (causal && k_start > q_start + BQ - 1) break;
    if (causal && window > 0 && k_start + BK - 1 <= q_start - window) continue;

    __syncthreads();  // the previous tile's K and V are no longer read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D, row = k_start + r;
      Ks[r * (D + 1) + c] = row < Skv ? repro::to_f32(kb[static_cast<size_t>(row) * D + c]) : 0.f;
    }
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int r = i / DV, c = i % DV, row = k_start + r;
      Vs[r * DV + c] = row < Skv ? repro::to_f32(vb[static_cast<size_t>(row) * DV + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_start + tr * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k_start + tc + 16 * j;
        float x = s[i][j];
        if (logit_cap > 0.f) x = logit_cap * tanhf(x / logit_cap);
        bool keep = k_pos < Skv;
        if (causal) keep = keep && k_pos <= q_pos;
        if (window > 0) keep = keep && q_pos - k_pos < window;
        s[i][j] = keep ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = repro::segment_max<16>(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(tr * 4 + i) * (BK + 1) + tc + 16 * j] = p;
        row_sum += p;
      }
      row_sum = repro::segment_sum<16>(row_sum);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row of P is written and read by the same half-warp

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[kk * DV + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
    __syncwarp();  // P reads finish before the next tile overwrites P
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_start + tr * 4 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[static_cast<size_t>(row) * DV + tc + 16 * c] = repro::from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                   int Hkv, int Sq, int Skv, int causal, int window, float logit_cap,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, DV>();
  auto kernel = flash_attn_fwd_kernel<T, D, DV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Sq, Skv, scale, causal, window, logit_cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                     int Hkv, int Sq, int Skv, int d, int dv, int causal, int window,
                     float logit_cap, cudaStream_t stream) {
  if (d == 64 && dv == 64)
    return launch<T, 64, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, logit_cap, stream);
  if (d == 128 && dv == 128)
    return launch<T, 128, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, logit_cap, stream);
  if (d == 64 && dv == 128)
    return launch<T, 64, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, logit_cap, stream);
  if (d == 128 && dv == 64)
    return launch<T, 128, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, logit_cap, stream);
  if (d == 256 && dv == 256)
    return launch<T, 256, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, logit_cap, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Hq, Sq, d), k (B, Hkv, Skv, d), v (B, Hkv, Skv, dv), o (B, Hq, Sq, dv),
// all contiguous and of one type: f32, or bf16 when is_bf16. Returns the CUDA
// error of the launch (0 when it was accepted).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int B, int Hq, int Hkv, int Sq, int Skv, int d, int dv,
                                         int is_bf16, int causal, int window, float logit_cap,
                                         void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, d, dv, causal, window,
                                   logit_cap, s);
  return dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, d, dv, causal, window, logit_cap, s);
}
