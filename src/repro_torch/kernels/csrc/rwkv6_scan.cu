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
// What bounds it on this card: operations. Per token and head the sequential
// form does 5 d^2 f32 operations (three FP instructions per state element:
// an FFMA for y, an FMUL for k v, an FFMA for S) against 5 d elements read or
// written; at the RWKV-6 serving shape (B 8, H 64, T 1024, d 64, bf16) that
// is 10.7 GFLOP (0.16 ms at 67 TFLOP/s) against 0.35 GB (0.105 ms at 3.35
// TB/s). The sequential form stays: its FMA bound is within 1.5x of the byte
// bound, while the chunked form costs C times more arithmetic in its pairwise
// term and needs split operands to meet the f32 limit on the tensor cores.
//
// What the design does about it. Each state element lives in one register
// for the whole sequence. A block per (b, h) splits S into P = 4 row groups
// of d/4 rows; one warp holds one row group of every column (C = d/32
// columns per thread at d 64; at d 16 a warp holds two row groups), so the r,
// k and w that a warp reads for a token are the same for all its lanes: one
// broadcast float4 per four rows, no bank conflicts, each value used for C
// columns. (A column's P threads on adjacent lanes, reduced by shuffles, make
// every warp read all d rows per token; that layout was slower than one
// thread per column.) Per token a thread sums r_i S_ij over its rows into two
// accumulators per column (chains of d/8 FMAs), updates S_ij = w_i S_ij +
// k_i v_j, and stores its partial y in shared memory. Chunks of CH tokens
// arrive by 16-byte cp.async into a pair of raw stages, chunk c+2 copied while
// chunk c is computed. Between the block's two barriers per chunk, every
// thread converts four elements at a time of the next stage to f32, summing
// each token's bonus r . (u * k) over d/4 lanes, and writes the previous
// chunk's y: the P partials added by halves, plus bonus * v, in 16-byte
// stores. The TPU's sequential chunk axis and VMEM state become the block's
// loop over T; the independent (b, h) pairs become the grid.
//
// What holds it now: FP32 instruction issue. Per token a thread issues 96 FP
// instructions for its 32 state elements at d 64 and about 19 others (the
// loads of r, k, w and v, the partial-y store, the loop); the two passes
// between the barriers add about a tenth more instructions, and no products
// run in the block while they do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int CH = 16;  // tokens per chunk
constexpr int P = 4;    // row groups of S, one warp's worth of rows each

// threads per block and columns per thread at head size D: a warp spans all
// D columns of one row group (two row groups at D 16)
__host__ __device__ constexpr int columns_per_thread(int D) { return D == 64 ? 2 : 1; }
__host__ __device__ constexpr int threads(int D) { return P * D / columns_per_thread(D); }

template <typename T>
constexpr int smem_bytes(int D) {
  return 2 * 4 * CH * D * static_cast<int>(sizeof(T))  // raw stages of r, k, v, w
         + 3 * CH * D * 4                                // r, k, w in f32
         + 2 * CH * D * 4                                // v in f32, two chunks
         + CH * P * D * 4                                // partial y per row group
         + 2 * CH * 4;                                   // bonus per token, two chunks
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 b = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// C (1 or 2) consecutive floats of shared memory, as one access
template <int C>
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  if constexpr (C == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x, x[1] = f.y;
  } else {
    x[0] = *p;
  }
}
template <int C>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// 16 bytes of output: 4 f32 or 8 bf16 (rounded to nearest even, as torch's cast)
__device__ __forceinline__ void store16(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* x) {
  uint4 out;
  unsigned* o = reinterpret_cast<unsigned*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
    o[e] = *reinterpret_cast<const unsigned*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = out;
}

template <typename T, int D>
__global__ void __launch_bounds__(threads(D), 4)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_out, int H, int Tlen) {
  constexpr int NT = threads(D);
  constexpr int C = columns_per_thread(D);
  constexpr int R = D / P;                // rows per thread
  constexpr int M = R / 4;                // float4 row groups per thread
  constexpr int NCH = M >= 2 ? 2 : 1;     // independent sum chains per column
  constexpr int VEC = 16 / sizeof(T);     // outputs per 16-byte store
  constexpr int ARRAY = CH * D;           // elements of one array in a chunk
  constexpr int PIECES = ARRAY * sizeof(T) / 16;  // 16-byte copies of one array in a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem);    // [stage][r, k, v, w][CH][D]
  float* fr = reinterpret_cast<float*>(smem + 2 * 4 * ARRAY * sizeof(T));
  float* fk = fr + ARRAY;
  float* fw = fk + ARRAY;
  float* fv = fw + ARRAY;                 // [chunk % 2][CH][D]: read again by the next chunk's y pass
  float* ypart = fv + 2 * ARRAY;          // [CH][P][D]
  float* bonus = ypart + CH * P * D;      // [chunk % 2][CH]

  const int h = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = tid * C / D;              // row group: rows R g .. R g + R - 1
  const int j0 = tid * C % D;             // columns j0 .. j0 + C - 1
  const size_t bh = static_cast<size_t>(blockIdx.y) * H + h;
  const size_t seq = bh * Tlen * D;
  const T* in[4] = {r + seq, k + seq, v + seq, w + seq};
  T* yp = y + seq;
  const int chunks = (Tlen + CH - 1) / CH;

  // copy chunk c of r, k, v, w into raw stage c % 2 (rows past T are not copied)
  auto issue = [&](int c) {
    if (c < chunks) {
      const int pieces = min(CH, Tlen - c * CH) * D * static_cast<int>(sizeof(T)) / 16;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const char* src = reinterpret_cast<const char*>(in[a] + static_cast<size_t>(c) * ARRAY);
        char* dst = reinterpret_cast<char*>(raw + ((c & 1) * 4 + a) * ARRAY);
#pragma unroll
        for (int it = 0; it < (PIECES + NT - 1) / NT; ++it) {
          const int q = tid + it * NT;
          if (q < pieces) cp_async16(dst + 16 * q, src + 16 * q);
        }
      }
    }
    cp_async_commit();
  };
  // y of chunk c = (the P partials added by halves) + bonus v, VEC outputs a
  // thread, one 16-byte store each; rows past T take no part
  auto emit = [&](int c) {
    const int n = min(CH, Tlen - c * CH);
    const float* fvc = fv + (c & 1) * ARRAY;
    const float* bc = bonus + (c & 1) * CH;
    for (int q = tid; q < n * D / VEC; q += NT) {
      const int t = q * VEC / D, j = q * VEC % D;
      float out[VEC];
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        float4 pg[P];
#pragma unroll
        for (int gg = 0; gg < P; ++gg) pg[gg] = *reinterpret_cast<const float4*>(ypart + (t * P + gg) * D + j + e);
#pragma unroll
        for (int half = P / 2; half > 0; half /= 2)
#pragma unroll
          for (int gg = 0; gg < half; ++gg) {
            pg[gg].x += pg[gg + half].x;
            pg[gg].y += pg[gg + half].y;
            pg[gg].z += pg[gg + half].z;
            pg[gg].w += pg[gg + half].w;
          }
        const float4 v4 = *reinterpret_cast<const float4*>(fvc + t * D + j + e);
        out[e] = fmaf(bc[t], v4.x, pg[0].x);
        out[e + 1] = fmaf(bc[t], v4.y, pg[0].y);
        out[e + 2] = fmaf(bc[t], v4.z, pg[0].z);
        out[e + 3] = fmaf(bc[t], v4.w, pg[0].w);
      }
      store16(yp + static_cast<size_t>(c * CH + t) * D + j, out);
    }
  };
  issue(0);
  issue(1);

  // this thread's four elements of u in the conversion pass (NT is a multiple of D / 4)
  const float4 u4 = *reinterpret_cast<const float4*>(u + static_cast<size_t>(h) * D + 4 * (tid % (D / 4)));
  float s[C][R];
  const float* s0p = s0 + bh * D * D;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) s[c][i] = s0p[(R * g + i) * D + j0 + c];

  for (int ch = 0; ch < chunks; ++ch) {
    const int n = min(CH, Tlen - ch * CH);
    cp_async_wait<1>();
    __syncthreads();  // stage ch % 2 landed; the previous chunk's products are done

    if (ch > 0) emit(ch - 1);
    // convert the stage to f32 and sum each token's bonus, four elements a
    // thread and D / 4 lanes a token (every warp takes the same trips)
    const T* st = raw + (ch & 1) * 4 * ARRAY;
    float* fvc = fv + (ch & 1) * ARRAY;
    for (int q = tid; q < ARRAY / 4; q += NT) {
      const float4 r4 = load4(st + 4 * q), k4 = load4(st + ARRAY + 4 * q);
      reinterpret_cast<float4*>(fr)[q] = r4;
      reinterpret_cast<float4*>(fk)[q] = k4;
      reinterpret_cast<float4*>(fvc)[q] = load4(st + 2 * ARRAY + 4 * q);
      reinterpret_cast<float4*>(fw)[q] = load4(st + 3 * ARRAY + 4 * q);
      float b = 0.f;
      b = fmaf(r4.x * u4.x, k4.x, b);
      b = fmaf(r4.y * u4.y, k4.y, b);
      b = fmaf(r4.z * u4.z, k4.z, b);
      b = fmaf(r4.w * u4.w, k4.w, b);
      b = repro::segment_sum<D / 4>(b);
      if (q % (D / 4) == 0) bonus[(ch & 1) * CH + q / (D / 4)] = b;
    }
    __syncthreads();  // f32 rows ready; the stage is free for chunk ch + 2; partial y read
    issue(ch + 2);

#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      float vv[C];
      load_vec<C>(fvc + t * D + j0, vv);
      float acc[C][NCH];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int a = 0; a < NCH; ++a) acc[c][a] = 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = R * g + 4 * m;  // the same for every lane of a warp: broadcast
        const float4 r4 = *reinterpret_cast<const float4*>(fr + t * D + i);
        const float4 k4 = *reinterpret_cast<const float4*>(fk + t * D + i);
        const float4 w4 = *reinterpret_cast<const float4*>(fw + t * D + i);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float& a = acc[c][m % NCH];
          a = fmaf(r4.x, s[c][4 * m], a);
          a = fmaf(r4.y, s[c][4 * m + 1], a);
          a = fmaf(r4.z, s[c][4 * m + 2], a);
          a = fmaf(r4.w, s[c][4 * m + 3], a);
          s[c][4 * m] = fmaf(w4.x, s[c][4 * m], k4.x * vv[c]);
          s[c][4 * m + 1] = fmaf(w4.y, s[c][4 * m + 1], k4.y * vv[c]);
          s[c][4 * m + 2] = fmaf(w4.z, s[c][4 * m + 2], k4.z * vv[c]);
          s[c][4 * m + 3] = fmaf(w4.w, s[c][4 * m + 3], k4.w * vv[c]);
        }
      }
      float part[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        part[c] = acc[c][0];
#pragma unroll
        for (int a = 1; a < NCH; ++a) part[c] += acc[c][a];
      }
      store_vec<C>(ypart + (t * P + g) * D + j0, part);
    }
  }
  __syncthreads();  // the last chunk's partial y is in
  if (chunks > 0) emit(chunks - 1);

  float* sp = s_out + bh * D * D;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float row[C];
#pragma unroll
    for (int c = 0; c < C; ++c) row[c] = s[c][i];
    store_vec<C>(sp + (R * g + i) * D + j0, row);
  }
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const float* u,
                   const float* s0, void* y, float* s_out, int B, int H, int Tlen,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T>(D);
  const cudaError_t err =
      cudaFuncSetAttribute(wkv6_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  wkv6_kernel<T, D><<<grid, threads(D), bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, s0, static_cast<T*>(y), s_out, H, Tlen);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t config(int* out) {
  constexpr int bytes = smem_bytes<T>(D);
  cudaError_t err =
      cudaFuncSetAttribute(wkv6_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wkv6_kernel<T, D>, threads(D), bytes);
  out[0] = threads(D);
  out[1] = bytes;
  out[2] = blocks;
  out[3] = CH;
  out[4] = P;
  return err;
}

template <typename T>
cudaError_t config(int d, int* out) {
  if (d == 64) return config<T, 64>(out);
  if (d == 32) return config<T, 32>(out);
  if (d == 16) return config<T, 16>(out);
  return cudaErrorInvalidValue;
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

// The launch of the kernel at head size d: out[0] threads per block, out[1]
// dynamic shared memory per block in bytes, out[2] blocks resident per SM on
// the current device (the occupancy calculator's answer, registers included),
// out[3] tokens per chunk, out[4] row groups of S. Returns the CUDA error.
extern "C" int repro_wkv6_config(int d, int is_bf16, int* out) {
  return is_bf16 ? config<__nv_bfloat16>(d, out) : config<float>(d, out);
}
