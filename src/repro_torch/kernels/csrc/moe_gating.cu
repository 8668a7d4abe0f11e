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
// What bounds it on this card: bytes in principle, instructions and launch
// latency in practice. A few dozen operations per logit against 4 bytes
// read; at the largest prefill of deepseek-moe-16b (G 16, N 1024, E 64, k 6)
// the logits are 4.19 MB and the outputs 1.18 MB, 1.6 us at 3.35 TB/s. But a
// row is a chain of a few hundred dependent warp instructions (shuffles,
// exp, division, k rounds of argmax), so the rows have to be spread over
// every SM, and each round has to be short.
//
// What the design does about it: the group's N tokens are cut into tiles of
// TILE = 64 tokens, and both kernels run one block per (group, tile),
// G * ceil(N / TILE) blocks. Of 32, 64 and 128 tokens a tile, 64 was the
// fastest at deepseek-moe-16b's largest prefill on an H100 (PERF.md).
//
// Route kernel: a warp per token row, as many warps as the tile has rows (at
// most 32). Each lane holds the row's entries e = lane, lane + 32, ... in
// registers (coalesced loads) and takes the max and the sum by shuffles; the
// (N, E) probabilities never leave registers. Each of the k argmax rounds
// takes the lane's own best (value, lowest index), then two warp reductions
// (redux.sync): the largest value, compared as the bits of a probability
// (>= +0, or -inf once taken), which order as signed ints; then the lowest
// index among the lanes that hold it. That is the first maximum, as the
// (value, index) shuffle tree would give, in 2 steps instead of 10. It writes
// idx and gate, and lane j adds pick j to the tile's count per (rank j,
// expert e) in shared memory. A group of one tile (N <= TILE; a decode step)
// gets its slots in the same block, so it is one launch. Otherwise the block
// writes its (k, E) counts to a scratch tensor hist (G, T, k, E), every
// entry, so it needs no zeroing.
//
// Slots kernel, launched only when a group has T > 1 tiles: each block sums
// its group's histograms (they sit in L2; eight loads in flight a thread)
// into the slots claimed before its tile's rank-j picks of expert e,
//   base[t][j][e] = sum_{j' < j} sum_{all t'} hist[t'][j'][e]
//                 + sum_{t' < t} hist[t'][j][e],
// then reads the tile's picks from idx into shared memory, rank-major with a
// row of TILE + 1 (the walk's reads are conflict-free), and gives each its
// slot. Each block reads all T histograms of its group, so a group costs
// T^2 k E loads: 98304 at deepseek-moe-16b's prefill group (T 16, k 6,
// E 64), 1.1e8 at a group of 30000 tokens at k 8 (T 469).
// The walk spreads the tile's (rank, 32-token segment) pairs over all the
// block's warps: __match_any_sync groups the lanes of a segment that picked
// the same expert, a lane's rank among them plus the picks of that expert in
// the tile's earlier segments (counted from shared memory) plus base is its
// slot. The TPU kernel's (N, E) one-hot cumulative sums become these
// integer counts: the result is deterministic, no block waits on another,
// and nothing persists between calls (a CUDA graph may capture the call).
//
// Rounding is the plain version's (repro_torch.kernels.ref.moe_gating_ref),
// step for step, so that idx and pos agree exactly and gate to the bit: the
// same max, expf (no fast math), the sum over lanes by halves 16, 8, 4, 2, 1
// after each lane adds its own entries in index order (ref.lane_sum), one
// division per entry, and the k gates summed in pick order.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int TILE = 64;           // tokens a block
constexpr int STRIDE = TILE + 1;   // a rank's row of s_idx
constexpr int MAX_WARPS = 32;      // route block: a warp per row of the tile
constexpr int SLOT_THREADS = 512;  // slots block: a (rank, expert) count a thread at k E <= 512
constexpr int MAX_CHUNKS = 12;     // E <= 384 (kimi-k2's 384 experts)

struct Tile {
  int g, t;      // group, tile within the group
  size_t first;  // the tile's first token, counted over all groups
  int rows;      // tokens in the tile (the last tile of a group may be short)
};

__device__ __forceinline__ Tile tile_of(int N, int T) {
  Tile tile;
  tile.g = blockIdx.x / T;
  tile.t = blockIdx.x % T;
  tile.first = static_cast<size_t>(tile.g) * N + static_cast<size_t>(tile.t) * TILE;
  tile.rows = min(TILE, N - tile.t * TILE);
  return tile;
}

// Slots of one tile's picks. s_idx (k, STRIDE): the expert of each pick,
// rank-major; base (k, E): slots claimed before the tile's rank-j picks of
// each expert; pos: the tile's first row of the (rows, k) output.
__device__ void assign_slots(const int* s_idx, const int* base, int rows, int E, int k, int capacity,
                             int* pos) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int segments = (rows + 31) / 32;
  const unsigned lower = (1u << lane) - 1u;
  for (int p = warp; p < k * segments; p += warps) {
    const int j = p / segments;
    const int s = p - j * segments;
    const int* picks = s_idx + j * STRIDE;
    const int n = s * 32 + lane;
    const int e = n < rows ? picks[n] : -1 - lane;  // idle lanes match no one
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    int slot = __popc(peers & lower);
#pragma unroll 8
    for (int i = 0; i < s * 32; ++i) slot += picks[i] == e;  // broadcast reads
    if (n < rows) {
      slot += base[j * E + e];
      pos[static_cast<size_t>(n) * k + j] = slot < capacity ? slot : -1;
    }
  }
}

// CHUNKS = ceil(E / 32): the entries of a row each lane holds.
template <int CHUNKS>
__global__ void __launch_bounds__(MAX_WARPS * 32)
moe_gating_route_kernel(const float* __restrict__ logits, int* __restrict__ idx_out,
                        float* __restrict__ gate_out, int* __restrict__ pos_out,
                        int* __restrict__ hist, int N, int E, int k, int capacity, int renormalise,
                        int T) {
  extern __shared__ int smem[];
  int* s_count = smem;          // (k, E): the tile's picks of rank j per expert
  int* s_idx = smem + k * E;    // (k, STRIDE): the expert of every pick, rank-major
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const Tile tile = tile_of(N, T);
  for (int i = threadIdx.x; i < k * E; i += blockDim.x) s_count[i] = 0;
  __syncthreads();

  // Softmax and the k picks of each row, one warp per row.
  for (int r = warp; r < tile.rows; r += warps) {
    const size_t n = tile.first + r;
    const float* row = logits + n * E;
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
      // The warp's largest (value, lowest index): best is a probability
      // (>= +0) or -inf, so its bits order as signed ints.
      const int top = __reduce_max_sync(0xffffffffu, __float_as_int(best));
      arg = static_cast<int>(__reduce_min_sync(
          0xffffffffu, __float_as_int(best) == top ? static_cast<unsigned>(arg) : 0x7fffffffu));
      best = __int_as_float(top);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
        if (c * 32 + lane == arg) v[c] = -INFINITY;
      total = (j == 0) ? best : total + best;
      if (lane == j) {
        my_idx = arg;
        my_gate = best;
      }
    }
    if (lane < k) {  // lane j holds pick j
      atomicAdd(&s_count[lane * E + my_idx], 1);
      s_idx[lane * STRIDE + r] = my_idx;
      idx_out[n * k + lane] = my_idx;
      gate_out[n * k + lane] = renormalise ? my_gate / fmaxf(total, 1e-9f) : my_gate;
    }
  }
  __syncthreads();

  if (T > 1) {  // the slots kernel assigns them from every tile's counts
    int* h = hist + (static_cast<size_t>(tile.g) * T + tile.t) * k * E;
    for (int i = threadIdx.x; i < k * E; i += blockDim.x) h[i] = s_count[i];
    return;
  }
  // One tile: rank j's base per expert is the picks of all lower ranks.
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int run = 0;
    for (int j = 0; j < k; ++j) {
      const int c = s_count[j * E + e];
      s_count[j * E + e] = run;
      run += c;
    }
  }
  __syncthreads();
  assign_slots(s_idx, s_count, tile.rows, E, k, capacity, pos_out + tile.first * k);
}

__global__ void __launch_bounds__(SLOT_THREADS)
moe_gating_slots_kernel(const int* __restrict__ idx, const int* __restrict__ hist,
                        int* __restrict__ pos_out, int N, int E, int k, int capacity, int T) {
  extern __shared__ int smem[];
  const int kE = k * E;
  int* s_idx = smem;                  // (k, STRIDE): the tile's picks, rank-major
  int* s_total = s_idx + k * STRIDE;  // (k, E): the group's picks of rank j per expert
  int* s_base = s_total + kE;         // (k, E): slots claimed before the tile's rank-j picks
  const Tile tile = tile_of(N, T);
  const int* h = hist + static_cast<size_t>(tile.g) * T * kE;
  for (int i = threadIdx.x; i < kE; i += blockDim.x) {
    int before = 0, total = 0;
#pragma unroll 8
    for (int u = 0; u < T; ++u) {  // eight loads in flight
      const int c = h[static_cast<size_t>(u) * kE + i];
      total += c;
      before += u < tile.t ? c : 0;
    }
    s_total[i] = total;
    s_base[i] = before;
  }
  const int* tile_idx = idx + tile.first * k;
  for (int i = threadIdx.x; i < tile.rows * k; i += blockDim.x)
    s_idx[(i % k) * STRIDE + i / k] = tile_idx[i];
  __syncthreads();
  for (int i = threadIdx.x; i < kE; i += blockDim.x) {
    const int j = i / E;
    const int e = i - j * E;
    int b = s_base[i];
    for (int jj = 0; jj < j; ++jj) b += s_total[jj * E + e];
    s_base[i] = b;
  }
  __syncthreads();
  assign_slots(s_idx, s_base, tile.rows, E, k, capacity, pos_out + tile.first * k);
}

using RouteKernel = void (*)(const float*, int*, float*, int*, int*, int, int, int, int, int, int);

RouteKernel route_kernel(int E) {
  switch ((E + 31) / 32) {
#define REPRO_GATING_CASE(C) \
  case C:                    \
    return moe_gating_route_kernel<C>;
    REPRO_GATING_CASE(1) REPRO_GATING_CASE(2) REPRO_GATING_CASE(3) REPRO_GATING_CASE(4)
    REPRO_GATING_CASE(5) REPRO_GATING_CASE(6) REPRO_GATING_CASE(7) REPRO_GATING_CASE(8)
    REPRO_GATING_CASE(9) REPRO_GATING_CASE(10) REPRO_GATING_CASE(11) REPRO_GATING_CASE(12)
#undef REPRO_GATING_CASE
  }
  return nullptr;
}

int tiles(int N) { return (N + TILE - 1) / TILE; }

bool valid(int G, int N, int E, int k) {
  return G > 0 && N > 0 && E > 0 && E <= 32 * MAX_CHUNKS && k >= 1 && k <= E && k <= 32 &&
         static_cast<long long>(G) * tiles(N) <= INT_MAX && static_cast<long long>(N) * k <= INT_MAX;
}

int route_threads(int N) { return 32 * std::min(MAX_WARPS, std::min(TILE, N)); }
size_t route_smem(int E, int k) { return static_cast<size_t>(k) * (E + STRIDE) * sizeof(int); }
size_t slots_smem(int E, int k) { return static_cast<size_t>(k) * (STRIDE + 2 * E) * sizeof(int); }

}  // namespace

// logits (G, N, E) f32 contiguous; idx, gate, pos (G, N, k) int32 / f32 /
// int32 contiguous; hist (G, ceil(N / 64), k, E) int32 scratch, unused
// (may be null) when N <= 64. 1 <= k <= min(E, 32), E <= 384, capacity >= 0,
// N k within int. Launches the route kernel
// and, when a group has more than one tile, the slots kernel. Returns the
// CUDA error of the launches (0 when they were accepted).
extern "C" int repro_moe_gating_fwd(const void* logits, void* idx, void* gate, void* pos, void* hist,
                                    int G, int N, int E, int k, int capacity, int renormalise,
                                    void* stream) {
  if (!valid(G, N, E, k) || capacity < 0) return cudaErrorInvalidValue;
  const int T = tiles(N);
  if (T > 1 && hist == nullptr) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* i = static_cast<int*>(idx);
  auto* p = static_cast<int*>(pos);
  auto* h = static_cast<int*>(hist);
  RouteKernel route = route_kernel(E);
  const size_t smem = route_smem(E, k);
  cudaError_t err = cudaFuncSetAttribute(route, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  route<<<G * T, route_threads(N), smem, s>>>(static_cast<const float*>(logits), i,
                                              static_cast<float*>(gate), p, h, N, E, k, capacity,
                                              renormalise, T);
  err = cudaGetLastError();
  if (err != cudaSuccess || T == 1) return err;
  const size_t smem2 = slots_smem(E, k);
  err = cudaFuncSetAttribute(moe_gating_slots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return err;
  moe_gating_slots_kernel<<<G * T, SLOT_THREADS, smem2, s>>>(i, h, p, N, E, k, capacity, T);
  return cudaGetLastError();
}

// The launches for one group of N tokens over E experts at top-k k: out[0]
// tiles a group, then for the route kernel out[1] threads
// per block, out[2] dynamic shared memory in bytes, out[3] registers a
// thread, out[4] blocks resident per SM on the current device (the occupancy
// calculator's answer), and out[5..8] the same for the slots kernel (which
// runs only when out[0] > 1). Returns the CUDA error.
extern "C" int repro_moe_gating_config(int N, int E, int k, int* out) {
  if (!valid(1, N, E, k)) return cudaErrorInvalidValue;
  out[0] = tiles(N);
  const void* kernels[2] = {reinterpret_cast<const void*>(route_kernel(E)),
                            reinterpret_cast<const void*>(moe_gating_slots_kernel)};
  const int threads[2] = {route_threads(N), SLOT_THREADS};
  const size_t smem[2] = {route_smem(E, k), slots_smem(E, k)};
  for (int w = 0; w < 2; ++w) {
    cudaError_t err = cudaFuncSetAttribute(kernels[w], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem[w]));
    cudaFuncAttributes attrs;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, kernels[w]);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernels[w], threads[w], smem[w]);
    if (err != cudaSuccess) return err;
    out[1 + 4 * w] = threads[w];
    out[2 + 4 * w] = static_cast<int>(smem[w]);
    out[3 + 4 * w] = attrs.numRegs;
    out[4 + 4 * w] = blocks;
  }
  return cudaSuccess;
}
