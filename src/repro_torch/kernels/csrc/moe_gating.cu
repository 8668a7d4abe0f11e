// MoE gating, forward, for Hopper (sm_90a): softmax, top-k and capacity slots.
//
// Replaces: src/repro/kernels/moe_gating.py, `moe_gating_pallas` and its
// Pallas TPU kernel `_gating_kernel`. Same function, per dispatch group g of
// N tokens over E experts, from f32 router logits (G, N, E):
//   idx  (G, N, k) int32  the k experts of each token, by k rounds of argmax
//                         over the remaining probabilities (ties go to the
//                         lower expert, as the first maximum wins);
//   gate (G, N, k) f32    each pick's probability, renormalised by
//                         max(sum of the k, 1e-9);
//   pos  (G, N, k) int32  the pick's slot in its expert's buffer, j-major
//                         (every rank-0 pick of the group before any rank-1
//                         pick, tokens in order within a rank), or -1 past
//                         `capacity`; dropped picks still count.
//
// What bounds it on this card: bytes, and at the serving shapes launch
// latency. A few dozen operations per logit against 4 bytes read; at the
// largest prefill of deepseek-moe-16b (G 16, N 1024, E 64, k 6) the logits are
// 4.19 MB and the outputs 1.18 MB, 1.6 us at 3.35 TB/s.
//
// What the design does about it: one block per group, since capacity is
// counted per group and nothing crosses groups. Pass 1 gives each warp one
// token row at a time: each lane holds the row's entries e = lane, lane + 32,
// ... in registers (coalesced loads), takes the max and the sum by shuffles,
// and runs the k argmax rounds on (value, index) pairs by shuffles; the
// (N, E) probabilities never leave registers. The picks go to shared memory
// with a per-rank histogram of experts. Pass 2 turns the histogram into each
// rank's starting count per expert (all lower ranks' picks), so the k ranks
// are independent and warp j walks rank j's picks in token order, 32 at a
// time: __match_any_sync groups the lanes that picked the same expert, a
// lane's rank among them gives its slot, and the lowest of them advances the
// expert's count. The TPU kernel's (N, E) one-hot cumulative sums become these
// warp-level counts.
//
// Rounding is the plain version's (repro_torch.kernels.ref.moe_gating_ref),
// step for step, so that idx and pos agree exactly and gate to the bit: the
// same max, expf (no fast math), the sum over lanes by halves 16, 8, 4, 2, 1
// after each lane adds its own entries in index order (ref.lane_sum), one
// division per entry, and the k gates summed in pick order.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CHUNKS = 12;  // E <= 384 (kimi-k2's 384 experts)

// CHUNKS = ceil(E / 32): the entries of a row each lane holds.
template <int CHUNKS>
__global__ void __launch_bounds__(THREADS)
moe_gating_kernel(const float* __restrict__ logits, int* __restrict__ idx_out,
                  float* __restrict__ gate_out, int* __restrict__ pos_out, int N, int E, int k,
                  int capacity, int renormalise) {
  extern __shared__ int smem[];
  int* s_idx = smem;            // (N, k): the expert of every pick
  int* s_count = smem + N * k;  // (k, E): picks of rank j per expert, then rank j's base
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < k * E; i += THREADS) s_count[i] = 0;
  __syncthreads();

  const float* xg = logits + static_cast<size_t>(blockIdx.x) * N * E;
  const size_t out = static_cast<size_t>(blockIdx.x) * N * k;

  // Pass 1: softmax and the k picks of each row, one warp per row.
  for (int n = warp; n < N; n += WARPS) {
    const float* row = xg + static_cast<size_t>(n) * E;
    float v[CHUNKS];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int e = c * 32 + lane;
      v[c] = e < E ? row[e] : -INFINITY;
      m = fmaxf(m, v[c]);
    }
    m = repro::segment_max<32>(m);
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      v[c] = expf(v[c] - m);  // entries past E: expf(-inf) = 0
      s += v[c];
    }
    s = repro::segment_sum<32>(s);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) v[c] = c * 32 + lane < E ? v[c] / s : -INFINITY;

    int my_idx = 0;
    float my_gate = 0.0f, total = 0.0f;
    for (int j = 0; j < k; ++j) {
      float best = -INFINITY;
      int arg = 0x7fffffff;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        if (v[c] > best) {  // strict: the lower index keeps a tie
          best = v[c];
          arg = c * 32 + lane;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
        if (ob > best || (ob == best && oa < arg)) {
          best = ob;
          arg = oa;
        }
      }
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
        if (c * 32 + lane == arg) v[c] = -INFINITY;
      total = (j == 0) ? best : total + best;
      if (lane == j) {
        my_idx = arg;
        my_gate = best;
      }
      if (lane == 0) atomicAdd(&s_count[j * E + arg], 1);
    }
    if (lane < k) {
      s_idx[n * k + lane] = my_idx;
      idx_out[out + static_cast<size_t>(n) * k + lane] = my_idx;
      gate_out[out + static_cast<size_t>(n) * k + lane] = renormalise ? my_gate / fmaxf(total, 1e-9f) : my_gate;
    }
  }
  __syncthreads();

  // Rank j's base count per expert: the picks of all lower ranks.
  for (int e = threadIdx.x; e < E; e += THREADS) {
    int run = 0;
    for (int j = 0; j < k; ++j) {
      const int c = s_count[j * E + e];
      s_count[j * E + e] = run;
      run += c;
    }
  }
  __syncthreads();

  // Pass 2: capacity slots, warp j walking rank j's picks in token order.
  const unsigned lower = (1u << lane) - 1u;
  for (int j = warp; j < k; j += WARPS) {
    int* count = s_count + j * E;
    for (int t = 0; t < N; t += 32) {
      const int n = t + lane;
      const int e = n < N ? s_idx[n * k + j] : -1 - lane;  // idle lanes match no one
      const unsigned peers = __match_any_sync(0xffffffffu, e);
      const int rank = __popc(peers & lower);
      if (n < N) {
        const int slot = count[e] + rank;
        pos_out[out + static_cast<size_t>(n) * k + j] = slot < capacity ? slot : -1;
      }
      __syncwarp();
      if (n < N && rank == 0) count[e] += __popc(peers);
      __syncwarp();
    }
  }
}

template <int CHUNKS>
cudaError_t launch(const float* logits, int* idx, float* gate, int* pos, int G, int N, int E, int k,
                   int capacity, int renormalise, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(N) * k + static_cast<size_t>(k) * E) * sizeof(int);
  auto kernel = moe_gating_kernel<CHUNKS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<G, THREADS, smem, stream>>>(logits, idx, gate, pos, N, E, k, capacity, renormalise);
  return cudaGetLastError();
}

}  // namespace

// logits (G, N, E) f32 contiguous; idx, gate, pos (G, N, k) int32 / f32 /
// int32 contiguous. 1 <= k <= min(E, 32), E <= 384, capacity >= 0, and the
// block's shared memory (N k + k E) * 4 bytes within what a block may opt
// into. Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int repro_moe_gating_fwd(const void* logits, void* idx, void* gate, void* pos, int G,
                                    int N, int E, int k, int capacity, int renormalise,
                                    void* stream) {
  if (G <= 0 || N <= 0 || E <= 0 || E > 32 * MAX_CHUNKS || k < 1 || k > E || k > 32 ||
      capacity < 0)
    return cudaErrorInvalidValue;
  const auto* x = static_cast<const float*>(logits);
  auto* i = static_cast<int*>(idx);
  auto* g = static_cast<float*>(gate);
  auto* p = static_cast<int*>(pos);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((E + 31) / 32) {
#define REPRO_GATING_CASE(C) \
  case C:                    \
    return launch<C>(x, i, g, p, G, N, E, k, capacity, renormalise, s);
    REPRO_GATING_CASE(1) REPRO_GATING_CASE(2) REPRO_GATING_CASE(3) REPRO_GATING_CASE(4)
    REPRO_GATING_CASE(5) REPRO_GATING_CASE(6) REPRO_GATING_CASE(7) REPRO_GATING_CASE(8)
    REPRO_GATING_CASE(9) REPRO_GATING_CASE(10) REPRO_GATING_CASE(11) REPRO_GATING_CASE(12)
#undef REPRO_GATING_CASE
  }
  return cudaErrorInvalidValue;
}
