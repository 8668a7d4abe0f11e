// Row-wise RMSNorm, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py, `rmsnorm_pallas` and its Pallas TPU
// kernel `_rmsnorm_kernel`. Same function: y = x * rsqrt(mean(x^2) + eps) * w
// over the last axis, moments in f32, y in x's dtype.
//
// What bounds it on this card: bytes. It does about 4 operations per element
// it reads, far below the card's ratio of operations to memory bandwidth, so
// reading x once and writing y once at device-memory rate is the floor. To
// reach it every SM must keep enough bytes of x in flight to cover the
// latency of device memory, no byte of x may be read twice, and the grid
// must keep the SMs busy to the end.
//
// What the design does about it (the vector path):
// - Each row is read once, as 16-byte vectors (8 bf16 or 4 f32 values), into
//   registers, and stays there between the sum of squares and the scale. A
//   thread holds VPT <= 8 vectors of a row (a template parameter, so the
//   loads are unrolled and all issued before the first FMA). y is stored
//   evict-first. An x larger than L2 is loaded past L1 with 256-byte L2
//   fetches (1-2% faster there); a smaller one, which the op before may have
//   left in L2, by plain loads (up to 30% faster there).
// - A row's "team" is 1 warp up to 256 vectors a row, else 2, 4, 8 or 16
//   warps; the team's cross-warp sum goes through shared memory under one
//   named barrier (bar.sync 1 + team, team threads), never a block-wide
//   __syncthreads. A call of too few rows to give each SM 8 warps (a decode
//   batch) widens its teams, down to one vector a thread.
// - A team takes one row, and blocks are handed to the SMs as they free up;
//   narrow rows take several a team, so that a block reads at least 16 KB.
//   A persistent grid (one wave of blocks walking the rows) was 2-11% slower
//   at every shape above the 50 MB L2 (PERF.md, PR 26).
// - The weight (f32) is read through L1, where it stays, in 16-byte vectors:
//   staged in shared memory, each one-row block would load it again (twice
//   the row's bytes in bf16). A ring of rows in shared memory fed by TMA bulk
//   copies was 5-25% slower than the registers (PERF.md, PR 26).
// Sums: each 16-byte vector's squares by an FMA chain from 0, the thread's
// vectors added in order, then the lane tree (xor shuffles 16..1), then the
// team's warps added in order: tests/test_torch_kernels.py emulates it.
//
// The generic path: PR 11's two kernels (a warp a row up to D 1024, else a
// block of 256 threads a row, one element a thread per load, the row read
// twice) take what the vector path cannot: D not a multiple of the vector
// width, or x or y not on a 16-byte boundary. repro_rmsnorm_config reports
// which path a call takes and its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// The generic path (PR 11's kernels)
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// The vector path
// ---------------------------------------------------------------------------

constexpr int MAX_VPT = 8;          // 16-byte vectors a thread holds of a row
constexpr int MAX_TEAM_WARPS = 16;  // f32 at D 12288: 3072 vectors, 16 warps of 6
constexpr int VEC_THREADS = 256;    // a block's threads, or one team's when wider
constexpr int FEW_ROWS_WARPS = 8;   // warps an SM below which a call's teams widen
constexpr int MIN_BLOCK_BYTES = 16384;  // bytes of x a block reads at least, where the rows allow

template <typename T>
constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // values a 16-byte vector

// The 16-byte vector as f32 values, and back (bf16: round to nearest even).
template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float (&a)[VEC<T>]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[2 * i] = __uint_as_float(u[i] << 16);
      a[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = __uint_as_float(u[i]);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&a)[VEC<T>]) {
  uint32_t u[4];
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);  // .x the low half
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = __float_as_uint(a[i]);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// x streams from device memory: no line of it in L1, and L2 fetches it 256
// bytes at a time.
__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The sum of squares of this thread's vectors: each vector's FMA chain from
// 0, the vectors added in order.
template <typename T, int VPT>
__device__ __forceinline__ float thread_sum(const uint4 (&v)[VPT], int tl, int team_threads, int nvec) {
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (tl + k * team_threads < nvec) {
      float a[VEC<T>];
      unpack<T>(v[k], a);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < VEC<T>; ++j) s = fmaf(a[j], a[j], s);
      ss += s;
    }
  }
  return ss;
}

// The row's sum over the team: the lane tree, then (teams of more than one
// warp) each warp's sum through shared memory, added in warp order under the
// team's named barrier. `slot` holds two sums a warp of the block,
// alternating by row, so a warp writes a row's sum only after every warp of
// its team has passed the previous row's barrier and so read the sum of the
// row before.
__device__ __forceinline__ float team_sum(float ss, float (*slot)[MAX_TEAM_WARPS], int parity, int team,
                                          int team_warps) {
  ss = repro::segment_sum<32>(ss);
  if (team_warps == 1) return ss;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) slot[parity][warp] = ss;
  asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(32 * team_warps) : "memory");
  const float* mine = slot[parity] + team * team_warps;
  ss = mine[0];
  for (int i = 1; i < team_warps; ++i) ss += mine[i];
  return ss;
}

// y's vectors of this thread: x * r * w. w (16-byte aligned) is read
// through L1, where it stays: x and y pass L1 by.
template <typename T, int VPT>
__device__ __forceinline__ void scale_store(const uint4 (&v)[VPT], const float* __restrict__ w, float r,
                                            T* __restrict__ yr, int tl, int team_threads, int nvec) {
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = tl + k * team_threads;
    if (c < nvec) {
      float a[VEC<T>];
      unpack<T>(v[k], a);
      const float4* wv = reinterpret_cast<const float4*>(w) + c * (VEC<T> / 4);
#pragma unroll
      for (int q = 0; q < VEC<T> / 4; ++q) {
        const float4 wq = __ldg(wv + q);
        a[4 * q] = a[4 * q] * r * wq.x;
        a[4 * q + 1] = a[4 * q + 1] * r * wq.y;
        a[4 * q + 2] = a[4 * q + 2] * r * wq.z;
        a[4 * q + 3] = a[4 * q + 3] * r * wq.w;
      }
      __stcs(reinterpret_cast<uint4*>(yr) + c, pack<T>(a));  // y streams out: evict it first
    }
  }
}

template <typename T, int VPT>
__device__ __forceinline__ void load_row(uint4 (&v)[VPT], const T* __restrict__ xr, int tl, int team_threads,
                                         int nvec, bool stream_x) {
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = tl + k * team_threads;
    const uint4* p = reinterpret_cast<const uint4*>(xr) + c;
    v[k] = c >= nvec ? make_uint4(0, 0, 0, 0) : stream_x ? load_stream(p) : __ldg(p);
  }
}

// A block of blockDim.x / (32 * team_warps) teams; team t of block b takes
// rows b * teams + t, then every gridDim.x * teams rows after it.
// At most 64 registers a thread (two blocks of 512 threads an SM): left to
// itself, ptxas gave 8 vectors a thread 99 and an SM 16 warps.
template <typename T, int VPT>
__global__ void __launch_bounds__(2 * VEC_THREADS, 2)
rmsnorm_vec_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y, long long rows,
                   int D, int team_warps, int stream_x, float eps) {
  __shared__ float slot[2][MAX_TEAM_WARPS];
  const int nvec = D / VEC<T>, team_threads = 32 * team_warps;
  const int team = threadIdx.x / team_threads, tl = threadIdx.x % team_threads;
  const int teams = blockDim.x / team_threads;
  const long long stride = static_cast<long long>(gridDim.x) * teams;
  int parity = 0;
  for (long long row = static_cast<long long>(blockIdx.x) * teams + team; row < rows; row += stride) {
    uint4 v[VPT];
    load_row<T, VPT>(v, x + row * D, tl, team_threads, nvec, stream_x);
    float ss = thread_sum<T, VPT>(v, tl, team_threads, nvec);
    ss = team_sum(ss, slot, parity, team, team_warps);
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    scale_store<T, VPT>(v, w, r, y + row * D, tl, team_threads, nvec);
    parity ^= 1;
  }
}

// ---------------------------------------------------------------------------
// The plan of a call and its launch
// ---------------------------------------------------------------------------

enum Path { GENERIC = 0, VECTOR = 1 };

struct Plan {
  int path = GENERIC, team_warps = 0, vpt = 0, threads = THREADS, teams = 0, grid = 0, blocks_per_sm = 0, sms = 0,
      l2_bytes = 0, stream_x = 0;
  long long rows_per_team = 0;
};

// Blocks of `kernel` resident per SM at `threads`, once per (device, kernel,
// threads); the first call for a kernel on a device has it prefer L1 to
// shared memory (the weight stays in L1).
cudaError_t resident(const void* kernel, int threads, int& blocks) {
  static std::mutex lock;
  static std::map<std::pair<int, const void*>, std::map<int, int>> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  auto kern = known.find({dev, kernel});
  if (kern == known.end()) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxL1);
    if (err != cudaSuccess) return err;
    kern = known.emplace(std::make_pair(dev, kernel), std::map<int, int>()).first;
  }
  if (auto it = kern->second.find(threads); it != kern->second.end()) {
    blocks = it->second;
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  if (err == cudaSuccess && blocks < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) kern->second[threads] = blocks;
  return err;
}

template <typename T>
const void* vec_kernel(int vpt) {
  switch (vpt) {
    case 1: return reinterpret_cast<const void*>(&rmsnorm_vec_kernel<T, 1>);
    case 2: return reinterpret_cast<const void*>(&rmsnorm_vec_kernel<T, 2>);
    case 3: return reinterpret_cast<const void*>(&rmsnorm_vec_kernel<T, 3>);
    case 4: return reinterpret_cast<const void*>(&rmsnorm_vec_kernel<T, 4>);
    case 5: return reinterpret_cast<const void*>(&rmsnorm_vec_kernel<T, 5>);
    case 6: return reinterpret_cast<const void*>(&rmsnorm_vec_kernel<T, 6>);
    case 7: return reinterpret_cast<const void*>(&rmsnorm_vec_kernel<T, 7>);
    case 8: return reinterpret_cast<const void*>(&rmsnorm_vec_kernel<T, 8>);
    default: return nullptr;
  }
}

// misalign: the addresses of x and y OR-ed, modulo 16
cudaError_t make_plan(long long rows, int D, int is_bf16, int misalign, Plan& p) {
  if (rows <= 0 || rows > 0x7fffffffLL || D <= 0) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&p.l2_bytes, cudaDevAttrL2CacheSize, dev);
  if (err != cudaSuccess) return err;
  const int elt = is_bf16 ? 2 : 4, vec = 16 / elt;
  if (D % vec != 0 || misalign % 16 != 0) {  // the generic path
    p.path = GENERIC;
    p.threads = THREADS;
    p.teams = D <= WARP_ROWS_MAX_D ? THREADS / 32 : 1;
    p.team_warps = D <= WARP_ROWS_MAX_D ? 1 : THREADS / 32;
    p.grid = static_cast<int>((rows + p.teams - 1) / p.teams);
    p.rows_per_team = 1;
    const void* k = D <= WARP_ROWS_MAX_D
                        ? (is_bf16 ? reinterpret_cast<const void*>(&rmsnorm_warp_kernel<__nv_bfloat16>)
                                   : reinterpret_cast<const void*>(&rmsnorm_warp_kernel<float>))
                        : (is_bf16 ? reinterpret_cast<const void*>(&rmsnorm_block_kernel<__nv_bfloat16>)
                                   : reinterpret_cast<const void*>(&rmsnorm_block_kernel<float>));
    return resident(k, p.threads, p.blocks_per_sm);
  }
  const int nvec = D / vec;
  p.team_warps = 1;
  while (p.team_warps < MAX_TEAM_WARPS && nvec > 32 * p.team_warps * MAX_VPT) p.team_warps *= 2;
  p.vpt = (nvec + 32 * p.team_warps - 1) / (32 * p.team_warps);
  if (p.vpt > MAX_VPT) return cudaErrorInvalidValue;
  // Too few rows to give every SM FEW_ROWS_WARPS warps (a decode batch): the
  // row's latency is a thread's chain of vectors, so widen the teams, down to
  // one vector a thread, over more warps and SMs.
  while (p.team_warps < MAX_TEAM_WARPS && p.vpt > 1 &&
         rows * p.team_warps < static_cast<long long>(FEW_ROWS_WARPS) * p.sms) {
    p.team_warps *= 2;
    p.vpt = (nvec + 32 * p.team_warps - 1) / (32 * p.team_warps);
  }
  p.path = VECTOR;
  p.stream_x = rows * D * elt > p.l2_bytes;
  p.threads = VEC_THREADS > 32 * p.team_warps ? VEC_THREADS : 32 * p.team_warps;
  p.teams = p.threads / (32 * p.team_warps);
  err = resident(is_bf16 ? vec_kernel<__nv_bfloat16>(p.vpt) : vec_kernel<float>(p.vpt), p.threads,
                 p.blocks_per_sm);
  if (err != cudaSuccess) return err;
  // A row a team, and the blocks handed out to the SMs as they free up, so
  // that a slow SM takes fewer; narrow rows take several a team, so that a
  // block reads at least MIN_BLOCK_BYTES, while the rows still give every SM
  // a block.
  const long long block_bytes = static_cast<long long>(D) * elt * p.teams;
  const long long spread = (rows + static_cast<long long>(p.teams) * p.sms - 1) / (static_cast<long long>(p.teams) * p.sms);
  p.rows_per_team = (MIN_BLOCK_BYTES + block_bytes - 1) / block_bytes;
  if (p.rows_per_team > spread) p.rows_per_team = spread;
  const long long per_block = p.rows_per_team * p.teams;
  p.grid = static_cast<int>((rows + per_block - 1) / per_block);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const Plan& p, const void* x, const float* w, void* y, long long rows, int D, float eps,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (p.path == GENERIC) {
    if (D <= WARP_ROWS_MAX_D)
      rmsnorm_warp_kernel<T><<<p.grid, THREADS, 0, stream>>>(xt, w, yt, rows, D, eps);
    else
      rmsnorm_block_kernel<T><<<p.grid, THREADS, 0, stream>>>(xt, w, yt, D, eps);
    return cudaGetLastError();
  }
  int team_warps = p.team_warps, stream_x = p.stream_x;
  void* args[] = {&xt, &w, &yt, &rows, &D, &team_warps, &stream_x, &eps};
  return cudaLaunchKernel(vec_kernel<T>(p.vpt), dim3(p.grid), dim3(p.threads), args, 0, stream);
}

}  // namespace

// x and y (rows, D) contiguous, f32 or bf16 when is_bf16; w (D,) f32, on a
// 16-byte boundary. Returns the CUDA error of the launch (0 when it was
// accepted).
extern "C" int repro_rmsnorm_fwd(const void* x, const void* w, void* y, long long rows, int D,
                                 int is_bf16, float eps, void* stream) {
  Plan p;
  const int misalign = static_cast<int>((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16);
  cudaError_t err = make_plan(rows, D, is_bf16, misalign, p);
  if (err != cudaSuccess) return err;
  if (p.path != GENERIC && reinterpret_cast<uintptr_t>(w) % 16 != 0) return cudaErrorMisalignedAddress;
  auto s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (is_bf16) return launch<__nv_bfloat16>(p, x, wf, y, rows, D, eps, s);
  return launch<float>(p, x, wf, y, rows, D, eps, s);
}

// The launch for `rows` rows of D (f32, or bf16 when is_bf16) whose x and y
// sit `misalign` bytes past a 16-byte boundary (their addresses OR-ed, modulo
// 16): out[0] the path (0 generic, 1 vector), out[1] warps a team (a row's
// threads / 32), out[2] vectors a thread (0 on the generic path), out[3]
// threads a block, out[4] teams a block, out[5] blocks, out[6] blocks
// resident per SM (the occupancy calculator's answer), out[7] SMs, out[8]
// rows a team at most, out[9] the device's L2 bytes, out[10] 1 when x (more
// than L2 holds) is loaded past L1. Returns the CUDA error.
extern "C" int repro_rmsnorm_config(long long rows, int D, int is_bf16, int misalign, int* out) {
  Plan p;
  cudaError_t err = make_plan(rows, D, is_bf16, misalign, p);
  if (err != cudaSuccess) return err;
  const int vals[11] = {p.path, p.team_warps, p.vpt, p.threads, p.teams, p.grid, p.blocks_per_sm, p.sms,
                        static_cast<int>(p.rows_per_team), p.l2_bytes, p.stream_x};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return cudaSuccess;
}
