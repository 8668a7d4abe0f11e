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
// about 566 MB, 0.17 ms at 3.35 TB/s). The chain of one channel is T
// dependent multiply-adds, about 10 us at T 2304, far below that floor, so
// what decides the time is how many bytes are in flight from device memory
// at once: at a loaded latency near 1 us the card needs some 4 MB in flight.
//
// What the design does about it. One block per (batch row, tile of WT
// channels), one thread per channel owning h in a register and walking T in
// order; the TPU kernel's sequential chunk axis and VMEM carry become this
// loop. WT is the largest of 128, 64, 32, 16 that still gives every SM a
// block (8 x 2560: 128, 160 blocks; 1 x 2560: 16, 160 blocks), and the ring
// is sized so that every block is resident at once: each block walks all of
// T, so a second wave would double the time.
//
// The ring: a and b reach the chain through STAGES slots of shared memory,
// each `steps` time steps of the tile; while the chain runs on one stage the
// copies of the next STAGES - 1 are in flight. `steps` is chosen from B W so
// that the whole card holds at least IN_FLIGHT bytes of a and b in flight
// (8 x 2560 f32: 16 steps a stage, 32 in flight, 5 MB, a 48 KB ring a block;
// 1 x 2560 f32: 112 steps, 224 in flight, 4.4 MB, a 42 KB ring), capped by the
// shared memory that keeps the grid in one wave. More in flight than that
// was slower (on an H100 at 8 x 2560, four stages of 16 steps: 7.5 MB, 10%
// slower).
// Blocks have at least four warps: where the tile is narrower than that
// (WT 16, 32, 64), only the warps without a channel issue the copies, so the
// chain never waits on them (on an H100 at 1 x 2560: 0.040 -> 0.029 ms). The
// chain reads STEP_ALIGN steps of a and b from the ring into registers before
// it runs them, one shared-memory latency a group rather than one a step.
//
// Three ways to fill the ring, one per alignment, in the same kernel with
// the same ring and the same arithmetic: 16-byte cp.async where every row of
// a and b starts on a 16-byte boundary (W * elt % 16 == 0 and both pointers
// 16-byte aligned: the served shapes), 4-byte cp.async where rows are 4-byte
// aligned (bf16 at even W off 8, f32 at W off 4, or a view that starts off
// 16 bytes), and plain loads and shared stores, issued STAGES - 1 stages
// ahead, where bf16 rows are only 2-byte aligned (odd W, or a view that
// starts an odd element in). Columns past W (the last tile) are never copied
// and their threads run no chain; rows past T (the last stage) are never
// copied and the chain stops at T. y is stored per step, coalesced over the
// tile's channels.
//
// The product and the sum are rounded separately (no fused multiply-add), in
// t order, as the plain version rounds them, so the two agree to the bit in
// f32 and in bf16 (y rounded to nearest even, as torch's cast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int STAGES = 3;                   // ring slots: STAGES - 1 stages in flight
constexpr long long IN_FLIGHT = 4ll << 20;  // bytes of a and b in flight across the card
constexpr int STEP_ALIGN = 16;              // steps a stage, rounded up to a multiple of this
constexpr int TILES[] = {128, 64, 32, 16};  // channels a block, largest first

// threads a block: one a channel, at least four warps so that narrow tiles
// have warps that only copy
__host__ __device__ constexpr int threads_for(int WT) { return WT < 128 ? 128 : WT; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// one piece of COPY bytes from device memory into the ring
template <int COPY>
__device__ __forceinline__ void copy_piece(char* dst, const char* src) {
  if constexpr (COPY == 16) {
    cp_async16(dst, src);
  } else if constexpr (COPY == 4) {
    cp_async4(dst, src);
  } else {
    *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  }
}

// Block (tile x, batch row y): channels x * WT .. + WT of row y. Dynamic
// shared memory: the ring of a, then the ring of b, each STAGES x steps x WT.
template <typename T, int WT, int COPY>
__global__ void __launch_bounds__(threads_for(WT))
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ h_out, int Tlen, int W, int steps) {
  constexpr int NT = threads_for(WT);
  constexpr int PER_ROW = WT * static_cast<int>(sizeof(T)) / COPY;  // pieces in a full tile's row
  // the first thread that copies: past the chain's warps where the block has
  // warps without a channel, so that the chain never waits on the copies
  constexpr int COPIER = NT > WT ? (WT + 31) / 32 * 32 : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int stage_bytes = steps * WT * static_cast<int>(sizeof(T));
  char* ring_a = reinterpret_cast<char*>(smem);
  char* ring_b = ring_a + STAGES * stage_bytes;

  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * WT;
  const int bi = blockIdx.y;
  const int cols = min(WT, W - w0);
  const int pieces = cols * static_cast<int>(sizeof(T)) / COPY;  // exact: the path's alignment
  const size_t base = static_cast<size_t>(bi) * Tlen * W + w0;
  const size_t row_bytes = static_cast<size_t>(W) * sizeof(T);
  const int n_stages = (Tlen + steps - 1) / steps;

  // stage c of a and b into ring slot c % STAGES; rows past T are not copied
  auto issue = [&](int c) {
    if (c < n_stages && tid >= COPIER) {
      const int rows = min(steps, Tlen - c * steps);
      const size_t first = (base + static_cast<size_t>(c) * steps * W) * sizeof(T);
      const char* src_a = reinterpret_cast<const char*>(a) + first;
      const char* src_b = reinterpret_cast<const char*>(b) + first;
      const int slot = (c % STAGES) * stage_bytes;
      for (int q = tid - COPIER; q < rows * PER_ROW; q += NT - COPIER) {
        const int r = q / PER_ROW, k = q % PER_ROW;
        if (k < pieces) {
          const size_t g = r * row_bytes + k * COPY;
          const int s = slot + r * WT * static_cast<int>(sizeof(T)) + k * COPY;
          copy_piece<COPY>(ring_a + s, src_a + g);
          copy_piece<COPY>(ring_b + s, src_b + g);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count of groups per stage
  };

  const bool live = tid < cols;
  float h = live ? h0[static_cast<size_t>(bi) * W + w0 + tid] : 0.f;
  T* yp = y + base + tid;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) issue(c);

  for (int c = 0; c < n_stages; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage c has landed for every thread; slot (c - 1) % STAGES is free
    issue(c + STAGES - 1);
    if (live) {
      const int rows = min(steps, Tlen - c * steps);
      const int slot = (c % STAGES) * stage_bytes;
      const T* ra = reinterpret_cast<const T*>(ring_a + slot) + tid;
      const T* rb = reinterpret_cast<const T*>(ring_b + slot) + tid;
      T* yc = yp + static_cast<size_t>(c) * steps * W;
      // STEP_ALIGN steps of a and b into registers before their chain, so
      // that the chain waits on one shared-memory latency per group, not one
      // per step; only the last stage of T has a remainder
      int t = 0;
      for (; t + STEP_ALIGN <= rows; t += STEP_ALIGN) {
        float av[STEP_ALIGN], bv[STEP_ALIGN];
#pragma unroll
        for (int j = 0; j < STEP_ALIGN; ++j) {
          av[j] = repro::to_f32(ra[(t + j) * WT]);
          bv[j] = repro::to_f32(rb[(t + j) * WT]);
        }
#pragma unroll
        for (int j = 0; j < STEP_ALIGN; ++j) {
          h = __fadd_rn(__fmul_rn(av[j], h), bv[j]);
          yc[static_cast<size_t>(t + j) * W] = repro::from_f32<T>(h);
        }
      }
      for (; t < rows; ++t) {
        h = __fadd_rn(__fmul_rn(repro::to_f32(ra[t * WT]), h), repro::to_f32(rb[t * WT]));
        yc[static_cast<size_t>(t) * W] = repro::from_f32<T>(h);
      }
    }
  }
  cp_async_wait<0>();
  if (live) h_out[static_cast<size_t>(bi) * W + w0 + tid] = h;
}

// The launch for one call: out of B, T, W, the element size and the low bits
// of the two input pointers, and the card's SM count and shared memory.
struct Plan {
  int tile, steps, threads, smem, blocks, blocks_per_sm, copy, sms;
};

template <typename T, int WT, int COPY>
cudaError_t run(Plan& p, const void* a, const void* b, const float* h0, void* y, float* h_out,
                int B, int Tlen, int W, cudaStream_t stream, bool launch) {
  auto kernel = lru_scan_kernel<T, WT, COPY>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (!launch) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.blocks_per_sm, kernel, p.threads, p.smem);
  const dim3 grid((W + WT - 1) / WT, B);
  kernel<<<grid, p.threads, p.smem, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b), h0,
                                              static_cast<T*>(y), h_out, Tlen, W, p.steps);
  return cudaGetLastError();
}

template <typename T, int WT>
cudaError_t by_copy(Plan& p, const void* a, const void* b, const float* h0, void* y, float* h_out,
                    int B, int Tlen, int W, cudaStream_t stream, bool launch) {
  if (p.copy == 16) return run<T, WT, 16>(p, a, b, h0, y, h_out, B, Tlen, W, stream, launch);
  if (p.copy == 4) return run<T, WT, 4>(p, a, b, h0, y, h_out, B, Tlen, W, stream, launch);
  if constexpr (sizeof(T) == 2) {
    return run<T, WT, 2>(p, a, b, h0, y, h_out, B, Tlen, W, stream, launch);
  } else {
    return cudaErrorInvalidValue;  // f32 rows are always 4-byte aligned
  }
}

template <typename T>
cudaError_t dispatch(Plan& p, const void* a, const void* b, const float* h0, void* y, float* h_out,
                     int B, int Tlen, int W, cudaStream_t stream, bool launch) {
  switch (p.tile) {
    case 128: return by_copy<T, 128>(p, a, b, h0, y, h_out, B, Tlen, W, stream, launch);
    case 64: return by_copy<T, 64>(p, a, b, h0, y, h_out, B, Tlen, W, stream, launch);
    case 32: return by_copy<T, 32>(p, a, b, h0, y, h_out, B, Tlen, W, stream, launch);
    case 16: return by_copy<T, 16>(p, a, b, h0, y, h_out, B, Tlen, W, stream, launch);
    default: return cudaErrorInvalidValue;
  }
}

long long round_up(long long x, long long m) { return (x + m - 1) / m * m; }

// misalign: the two input pointers' addresses OR-ed, modulo 16
cudaError_t make_plan(int B, int Tlen, int W, int is_bf16, int misalign, Plan& p) {
  if (B <= 0 || Tlen < 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  int dev = 0, smem_sm = 0, smem_block = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  const int elt = is_bf16 ? 2 : 4;

  p.tile = TILES[3];
  for (int wt : TILES) {
    if (static_cast<long long>(B) * ((W + wt - 1) / wt) >= p.sms) {
      p.tile = wt;
      break;
    }
  }
  p.threads = threads_for(p.tile);
  p.blocks = B * ((W + p.tile - 1) / p.tile);
  const long long row = static_cast<long long>(W) * elt;
  p.copy = row % 16 == 0 && misalign % 16 == 0 ? 16 : row % 4 == 0 && misalign % 4 == 0 ? 4 : elt;

  // steps a stage: (STAGES - 1) stages of the whole grid hold IN_FLIGHT bytes
  // of a and b; no more than T needs; within the shared memory that keeps
  // every block resident at once (at least STEP_ALIGN steps, whatever the grid)
  const long long per_step = 2ll * B * W * elt;
  long long steps = round_up((IN_FLIGHT + per_step * (STAGES - 1) - 1) / (per_step * (STAGES - 1)), STEP_ALIGN);
  steps = std::min(steps, round_up(std::max(Tlen, 1), STEP_ALIGN));
  const int resident = (p.blocks + p.sms - 1) / p.sms;
  const long long budget = std::min<long long>(smem_block, smem_sm / resident - reserved);
  const long long fits = budget / (STAGES * 2ll * p.tile * elt) / STEP_ALIGN * STEP_ALIGN;
  p.steps = static_cast<int>(std::max<long long>(STEP_ALIGN, std::min(steps, fits)));
  p.smem = STAGES * 2 * p.steps * p.tile * elt;
  p.blocks_per_sm = 0;
  return cudaSuccess;
}

}  // namespace

// a, b, y (B, T, W) contiguous, f32 or bf16 when is_bf16; h0 and h_out (B, W)
// f32. T may be 0 (h_out = h0). Returns the CUDA error of the launch.
extern "C" int repro_lru_scan_fwd(const void* a, const void* b, const void* h0, void* y,
                                  void* h_out, int B, int T, int W, int is_bf16, void* stream) {
  Plan p;
  const int misalign = static_cast<int>((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16);
  cudaError_t err = make_plan(B, T, W, is_bf16, misalign, p);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h_out);
  if (is_bf16) return dispatch<__nv_bfloat16>(p, a, b, h0f, y, hf, B, T, W, s, true);
  return dispatch<float>(p, a, b, h0f, y, hf, B, T, W, s, true);
}

// The launch for a call of B x T x W (f32, or bf16 when is_bf16) whose input
// pointers sit `misalign` bytes past a 16-byte boundary (their addresses
// OR-ed, modulo 16): out[0] channels a block (WT), out[1] time steps a
// stage, out[2] stages of the ring, out[3] threads a block, out[4] dynamic
// shared memory a block in bytes, out[5] blocks, out[6] blocks resident per
// SM on the current device (the occupancy calculator's answer), out[7] bytes
// a copy (16 or 4: cp.async; 2: plain loads), out[8] SMs. Returns the CUDA
// error.
extern "C" int repro_lru_scan_config(int B, int T, int W, int is_bf16, int misalign, int* out) {
  Plan p;
  cudaError_t err = make_plan(B, T, W, is_bf16, misalign, p);
  if (err == cudaSuccess)
    err = is_bf16 ? dispatch<__nv_bfloat16>(p, nullptr, nullptr, nullptr, nullptr, nullptr, B, T, W, nullptr, false)
                  : dispatch<float>(p, nullptr, nullptr, nullptr, nullptr, nullptr, B, T, W, nullptr, false);
  if (err != cudaSuccess) return err;
  const int vals[9] = {p.tile, p.steps, STAGES, p.threads, p.smem, p.blocks, p.blocks_per_sm, p.copy, p.sms};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return cudaSuccess;
}
