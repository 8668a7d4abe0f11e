// Flash attention, forward, for Hopper (sm_90a): eight kernels behind one entry.
//
// Replaces: src/repro/kernels/flash_attention.py, `flash_attention` and its
// Pallas TPU kernel `_attn_kernel`. Same function: softmax(q k^T * d^-0.5)
// v with an online softmax over KV tiles, f32 running max m, sum l and
// accumulator acc, optional causal mask, sliding window and tanh logit cap,
// GQA and MQA through the KV head h / (Hq / Hkv), ragged Sq and Skv, output
// acc / max(l, 1e-30) in q's dtype, masked scores at the finite -1e30 (a
// fully masked row must not turn into NaN).
//
// bf16: `flash_attn_bf16_kernel`, on the tensor cores, at every pair but
// MLA's (96, 64), which has `flash_attn_bf16_mla_kernel` (below).
//
// What bounds it on this card: operations. At deepseek-moe-16b's prefill
// (B 8, H 16, S 2048, d 128, causal) the kept (q, k) pairs need 137 GFLOP of
// matrix products against 268 MB of q, k, v and o: 0.139 ms at the bf16
// tensor-core rate (989 TFLOP/s) against 0.080 ms at 3.35 TB/s. Griffin's
// local attention (B 8, 10 heads of 256 on one KV head, S 2304, window 2048)
// needs 215 GFLOP against 0.10 GB. Only wgmma reaches that rate; on the f32
// FMA units (67 TFLOP/s) the same work takes 15 times longer.
//
// What the design does about it. A block owns 128 query rows of one
// (b, hq) and has three warpgroups:
// - a producer warpgroup, of which one thread starts every copy: Q once, then
//   K and V tiles of 64 keys by TMA (3-D tensor maps over the contiguous
//   (B*H, S, d) views, 128-byte swizzle, 64-column boxes, rows past S
//   filled with zeros so a ragged tile never reads the next head) into a ring
//   of 2 (d 256) or 4 stages, each guarded by a full and an empty mbarrier;
//   `setmaxnreg` leaves it 24 registers;
// - two consumer warpgroups of 64 rows each, with 240 registers: S = Q K^T by
//   `wgmma ... m64n64k16` with both operands in shared memory (K-major), then
//   in f32 and in the plain version's order the scale d^-0.5, the tanh cap
//   and the masks, the online softmax on the accumulator fragment (a thread
//   holds two rows, so a row max or sum is two xor shuffles; scores are kept
//   in units of log2 e, so p is one subtraction and one exp2, and acc is
//   rescaled only when a row's max moved), and O += P V by `wgmma` with P
//   from registers (the S fragment repacked as bf16x2 is the A fragment) and
//   V from shared memory (MN-major, transposed).
// Tiles that the causal edge or the window masks completely for the block
// are never loaded (the tests of `_attn_kernel`), a warpgroup computes only
// the tiles live for its own rows, only the tiles that straddle an edge are
// masked, and query tiles run heaviest first so that causal blocks balance
// over the 132 SMs. Q is not pre-scaled: d^-0.5 is not a power of two at
// d 128, and a scaled bf16 Q would round.
//
// P keeps 16 bits. The Pallas kernel multiplies V by p in f32. One bf16
// rounding of p puts some outputs outside the limit that holds the kernel to
// the plain version (atol 1e-3, rtol 2^-7; one output rounding), so p is
// split: P_hi = bf16(p), P_lo = bf16(p - P_hi), and both P_hi V and P_lo V
// accumulate into the same f32 acc. That is 1.5 times the tensor work of a
// single product; l is summed from the f32 p.
//
// f32 at (d, dv) = (64, 64), nbi-100m's heads: `flash_attn_tf32_kernel`, on
// the tensor cores as 3xTF32 (and MLA's (96, 64): `flash_attn_tf32_mla_kernel`,
// the same block at other tiles, below). One TF32 product keeps 11 bits and cannot meet
// the f32 limit (atol 2e-5, rtol 1e-4); splitting each operand into x_hi =
// tf32(x) and x_lo = tf32(x - x_hi) (cvt.rna, low bits cleared) and summing
// a_hi b_hi + a_hi b_lo + a_lo b_hi in f32 keeps about 22. At nbi-100m's
// prefill (8 x 512, 12 heads, causal) that is 9.66 GFLOP of TF32 products:
// 0.0195 ms at 495 TFLOP/s, against 0.0482 ms for the 3.22 GFLOP of the
// function on the FMA units. The blocks, ring, liveness and softmax are the
// bf16 kernel's, with what TF32 changes:
// - both operands of a TF32 wgmma must be K-major, and a B operand comes from
//   shared memory, so the producer's three idle warps split each landed K
//   tile in place into K_hi with K_lo beside it, and write V^T_hi and V^T_lo
//   (keys contiguous) in the swizzled layout wgmma reads, behind a third
//   barrier per stage (ready); two stages of five 16 KB tiles;
// - the keys of each group of 8 in V^T are ordered 0 2 4 6 1 3 5 7, so that
//   the S accumulator fragment (keys 2t, 2t + 1) is the TF32 A fragment
//   (columns t, t + 4) with no shuffle;
// - each consumer warpgroup pre-scales its 64 rows of Q in f32 (as the Pallas
//   kernel does) and splits them once into Q_hi and Q_lo tiles in shared
//   memory. Q kept as register A fragments for the whole loop gave wrong S
//   after the first tile: in that build's SASS, registers holding Q were
//   reused inside the loop body after the products that read them;
// - the tensor cores round each wgmma's f32 sum toward zero, so the large
//   products (Q_hi K_hi, P_hi V_hi) and the small ones go to separate
//   accumulators, added once per tile on the FMA units; O is carried across
//   tiles there too.
// 128-byte swizzled rows hold 32 f32 columns, so d 64 is two panels; one k8
// step of TF32 is 32 bytes, as one k16 step of bf16.
//
// f32 at (d, dv) = (96, 64), minicpm3-4b's MLA heads in f32 activations (the
// continuous-batching engine's one-row inserts): `flash_attn_tf32_mla_kernel`,
// the same template (`tf32_block`) as the d 64 kernel at other tiles.
//
// What bounds it: operations. At one insert of 1000 tokens (40 heads, causal)
// the kept pairs need 6.41 GFLOP at the real widths, 19.2 GFLOP as three TF32
// products: 0.0388 ms at 495 TFLOP/s, against 0.0153 ms for the 51 MB of q, k,
// v and o at 3.35 TB/s. On the FMA units (the f32 kernel this file held
// before) the same function took 0.4267 ms against a 0.0956 ms bound.
//
// What d 96 changes (the d 64 layout at d 96 would take 295,992 bytes of
// shared memory, past the 232,448 a block may opt into):
// - 32-key tiles, two stages: Q and Q_lo 48 KB each, a stage K 12 KB, K_lo
//   12 KB, V 8 KB, V^T_hi and V^T_lo 8 KB each; 197,688 bytes in all (three
//   stages would take 246,864). S is a run of 12 wgmma m64n32k8 for each of
//   its three products (16 registers of S a thread), P V keeps m64n64k8 with P
//   from registers over 4 k8 steps; a tile has half the d 64 tile's scores, so
//   its barrier waits, commits and rescale votes cost twice as much a score;
// - d 96 is exactly three 32-column panels of Q and K (boxes of 32 columns by
//   128 rows and by 32 keys): no zero-filled columns, unlike the bf16 MLA
//   kernel's; V^T is one panel of 32 keys by 64 rows;
// - liveness, the edge tests and the stage protocol are the d 64 kernel's at
//   32-key tiles: a window under 32 keys can give the block's two warpgroups
//   different first tiles, and each still waits for and releases every stage
//   of the block;
// - S's small products have an accumulator of their own (16 registers): with
//   small serving both the m64n32 and the m64n64 products ptxas serialised
//   the wgmmas (warning C7511) and the kernel was 8% slower.
// Registers: 232 a consumer thread, 40 for the producer, no spills; phase 2
// of chip_smoke.py prints the count and the spills.
// Measured (PERF.md; H100 80GB HBM3 at 700 W): 0.203 ms at that insert,
// against 0.430 ms on the FMA units and 0.30 ms for SDPA: 5.2x the bound,
// as the d 64 kernel is at 5.3x. Timed without parts of the work (wrong results):
// without the producer's split of K and V 0.149 ms, without the P V
// products 0.182, without the softmax 0.195. The split on three warps, behind
// a ring of only two stages, is the largest part.
//
// f32 at (d, dv) = (128, 128), codeqwen1.5-7b's heads in f32 activations
// (the continuous-batching engine's one-row inserts, 32 heads):
// `flash_attn_tf32_d128_kernel`, the same template at 16-key tiles.
//
// What bounds it: operations. At one insert of 1000 tokens (32 heads,
// causal) the kept pairs need 8.20 GFLOP at the real widths, 24.6 GFLOP as
// three TF32 products: 0.0497 ms at 495 TFLOP/s, against 0.0196 ms for the
// 65.5 MB of q, k, v and o at 3.35 TB/s, and 0.122 ms on the FMA units.
//
// What d 128 changes (Q and Q_lo alone take 128 KB; a stage of 64 keys
// would take 160 KB and one of 32 keys 80 KB, so a ring fits only at 16
// keys):
// - 16-key tiles. S is a run of 16 wgmma m64n16k8 for each of its three
//   products (8 registers of S a thread, and 8 of its own for the small
//   products);
// - K and V come split. At 16 keys the block's own split (two stages of K,
//   K_lo, V, V^T_hi, V^T_lo, 214,072 bytes) made the split the longest part
//   and left only two stages against the TMA's latency: 0.344 ms at the
//   insert. A first kernel, `tf32_split_kv_kernel`, splits K and V of each
//   KV head once per call into scratch in global memory (K_hi, K_lo in K's
//   layout; V^T_hi, V^T_lo transposed, keys in vt_key order, padded to 32
//   keys with zeros), and the block loads them by TMA into three stages of
//   K_hi, K_lo, V^T_hi and V^T_lo, 230,456 bytes in all; a landed stage is
//   ready, and the producer's other three warps idle. The split kernel moves
//   98 MB at that insert; the pair takes 0.293 ms (PERF.md);
// - V^T at 16 keys has rows of 64 bytes: it is kept with the 64-byte swizzle
//   (a row's 16-byte chunk c at c ^ ((row / 2) % 4)), loaded by TMA boxes of
//   16 keys by 128 rows with that swizzle, and read through descriptors of
//   that layout (type 2, 8-row groups 512 bytes apart);
// - O is 128 columns: acc holds both 64-column halves (64 registers), and
//   P V runs each half in turn, m64n64k8 over the two k8 steps into pv and
//   small (32 registers each), added into its half of acc on the FMA units
//   before the next half, so that the arithmetic is the d 64 kernel's.
// Measured (PERF.md; H100 80GB HBM3 at 700 W): 0.293 ms at that insert,
// against 0.533 ms on the FMA units and 0.274 ms for SDPA.
//
// f32 at (128, 64) and (64, 128): `flash_attn_tf32_d128_dv64_kernel` and
// `flash_attn_tf32_d64_dv128_kernel`, the (128, 128) block at their widths
// (no served path runs them). K and V come split as at (128, 128), but at
// 32-key tiles: V^T's rows of 32 keys are 128 bytes, under the 128-byte
// swizzle in its TMA boxes and descriptors as the in-block split writes them.
// (128, 64) has one 64-column half of O and two stages (230,440 bytes; three
// would take 279,608), (64, 128) Q and K of two 32-column panels and three
// stages (214,072 bytes). At 2 x 16 heads x 1024, causal, the kept pairs need
// 6.45 GFLOP, 19.4 as three TF32 products: 0.0391 ms at 495 TFLOP/s.
// Measured (PERF.md; H100 80GB HBM3 at 700 W): 0.16 ms at (64, 128) and 0.18
// ms at (128, 64) against 0.22 and 0.25 ms at 16-key tiles in three stages,
// 0.41 and 0.43 ms on the FMA units, and 0.23 and 0.27 ms for SDPA.
//
// f32 at (256, 256), Griffin's heads (no served path runs f32 at d 256):
// `flash_attn_tf32_d256_kernel`, a cluster of two blocks that split the head
// dims. One block does not fit: at 64 query rows Q and Q_lo take 128 KB and
// two stages of 16 keys 128 KB more, past the 232,448 bytes a block may opt
// into. The cluster's two blocks own the same 128 query rows of one (b, hq);
// block r holds the (128, 128) block's tiles for columns [128 r, 128 r + 128)
// of Q, K_hi and K_lo and rows [128 r, 128 r + 128) of V^T_hi and V^T_lo,
// loaded by TMA through the same tensor maps at that offset (V^T's boxes are
// 128 rows), and writes those columns of O. What the cluster adds:
// - each consumer warpgroup computes its partial S (64 x 16) over its block's
//   128 columns exactly as the (128, 128) block does (16 k8 steps a chain, so
//   the round-toward-zero error stays as it is there) and adds the large and
//   small parts into one partial;
// - it stores the partial into the peer block's exchange slot for this
//   warpgroup and the live tile's parity (mapa + st.shared::cluster, thread
//   t's 16-byte chunk f at 2048 f + 16 t, so a warp's stores are contiguous),
//   arrives on the peer's barrier of that slot (mbarrier.arrive.release.cluster,
//   all 128 threads, so that each thread's stores are released by its own
//   arrival), waits on its own (try_wait.acquire.cluster) and adds the peer's
//   partial. f32 addition commutes, so both blocks hold the same bits of S,
//   then the same m, l, P and rescale votes; each multiplies P by its own 128
//   columns of V;
// - the two blocks have the same rows, so each warpgroup has the same live
//   tiles as its counterpart in the peer, and their trip counts agree. A slot
//   is written again two live tiles later, and only after the writer has
//   received its reader's partial for the tile between, which the reader sends
//   after it has read the slot: no barrier frees a slot, and
//   tests/test_torch_kernels.py runs this protocol (cluster_consumer_ops,
//   run_cluster) against a model of the barriers, where one slot a
//   warpgroup is overwritten before it is read;
// - a cluster barrier (barrier.cluster arrive and wait, every thread of both
//   blocks) follows the barriers' set-up, before anything arrives on the
//   peer's, and ends the kernel, so that no block exits while its peer may
//   still write its shared memory;
// - shared memory: Q and Q_lo 128 KB, two stages of K_hi, K_lo, V^T_hi and
//   V^T_lo (32 KB each), the slots (2 warpgroups x 2 x 4 KB) and the
//   barriers: 214,088 bytes. Three stages would not fit even beside one slot a
//   warpgroup (238,664). The launch asks the runtime how many clusters of two
//   such blocks the card can hold (cudaOccupancyMaxActiveClusters; 66 on an
//   H100) and returns an error if none.
// At 2 x 10 heads on one KV head x 1024, causal, window 512, the kept pairs
// need 8.06 GFLOP, 24.2 as three TF32 products: 0.0488 ms at 495 TFLOP/s.
//
// Head dims (d, dv): (64, 64), (128, 128), (64, 128), (128, 64), (256, 256),
// and (96, 64), MLA's prefill (minicpm3-4b: q and k are 64 nope + 32 rope
// columns, v 64); f32 runs a TF32 kernel at every pair.
//
// bf16 at (96, 64): `flash_attn_bf16_mla_kernel`, minicpm3-4b's prefill
// attention (62 a prefill).
//
// What bounds it: operations. At 8 x 40 heads x 2048, causal, the kept pairs
// need 215 GFLOP at the real widths, 0.217 ms at 989 TFLOP/s; with Q K^T
// over six k16 steps and P V twice (P's hi and lo parts) the tensor cores do
// 448 FLOP a pair, 301 GFLOP (0.304 ms). Per score the rest (the scale,
// masks on edge tiles, the max, one ex2 on the 16-a-cycle special-function
// unit, the sum into l, the hi/lo split) costs about as much issue time as
// the products. The d 128 design (`flash_attn_bf16_kernel`) ran the two
// halves one after the other at this pair: 0.87 ms.
//
// What the design does about it:
// - the two consumer warpgroups take turns issuing their products:
//   warpgroup w issues only inside its turn (bar.sync on named barrier
//   TURN_BAR + w) and hands the turn over (bar.arrive on the other's) as soon
//   as its products are issued, so that its softmax runs under the other's
//   products instead of both warpgroups reaching their softmax together;
// - 128-key tiles (S by m64n128k16, 64 registers a thread; P V as 8 k16
//   steps of m64n64k16 for each part) halve the barrier waits, commits and
//   rescales per score against 64-key tiles. A stage (K 32 KB in two panels,
//   V 16 KB) is released after its P V is complete, one turn after its S;
//   three stages keep one tile in flight ahead of the two in use;
// - inside a warpgroup, turn kt issues S_kt and then O += P_{kt-1} V_{kt-1}
//   in one go, waits for S alone (wait_group 1), runs the softmax of tile kt,
//   waits for P V, rescales O by the moved max and splits P_kt into hi and
//   lo (the A fragments of the next turn's P V). S, P and O each take one
//   register fragment: S is consumed into P before the next S is issued.
//   ptxas moves the wait for P V above the max and the exps (seen in the
//   SASS), so a warpgroup's softmax does not run under its own P V; forcing
//   it there (the wait made to depend on l) made the kernel slower, 1.00
//   against 0.86 ms (H100 80GB HBM3 at 700 W; PERF.md).
// Measured (PERF.md): the products alone, with no softmax, take 0.70 ms of
// the 0.86, Q K^T alone 0.41 and P V alone 0.53: each wgmma chain runs at
// about half the data-sheet rate here, and that, not the softmax or the
// loads (no change with the ring never reloaded past its first stages, or
// with 4 stages), is what holds the kernel now.
// Unequal trip counts: the block's two warpgroups do not have the same live
// tiles (a window's first live tile differs when it is under 64 keys; a
// warpgroup past Sq has none; with 64-key tiles, the causal diagonal gave
// the second one more). Both take one turn for every tile kt_begin ..
// kt_end - 1 of the block plus one for the last P V, kt_end - kt_begin + 1
// in all, and issue nothing in a turn that has no product for them (a tile
// not live is waited for and released, as before). Warpgroup 1 arrives on
// warpgroup 0's barrier once before its first turn and not after its last,
// so each bar.sync meets exactly one bar.arrive and no barrier is left part
// way when the block ends. tests/test_torch_kernels.py runs this protocol
// (mla_turns, run_mla_block) against a model of the barriers at every
// served shape and the edges.
// Registers: 240 a consumer thread (S 64, P hi and lo 64, O 32), 24 for the
// producer, as in the d 128 kernel; phase 2 of chip_smoke.py prints the
// count and the spills. Shared memory: Q 32 KB + 3 stages
// of 48 KB + the barriers and 1 KB of alignment slack, 181,304 bytes.
//
// d 96 is one and a half 64-column boxes. Q and K tiles keep two 64-column
// panels in shared memory (128 columns, the swizzle pattern unchanged); the
// tensor maps are encoded over the real 96 columns, so the second box's TMA
// load fills columns 96..127 with zeros (and still completes a full box of
// bytes on the barrier), and Q K^T runs d / 16 = 6 k16 steps, stopping at
// column 96. The scale is 96^-0.5, from the real d. No host-side padding, so
// no copy of q and k.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
// Codes at and above this are a CUresult from libcuda plus this base
// (errors.cu prints them); below it they are cudaError_t.
constexpr int ENCODE_ERROR_BASE = 10000;

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA ring, warp-specialised producer
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int BQ = 128;                       // query rows per block
constexpr int BK = 64;                        // keys per tile
constexpr int CONSUMERS = 2;                  // warpgroups of 64 query rows
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int ROW_BYTES = 128;                // one swizzled row: 64 bf16 columns

template <int D, int DV>
__host__ __device__ constexpr int stages() { return D + DV >= 512 ? 2 : 4; }

// 64-column panels of a Q or K tile: d 96 takes two, the second half zeros.
template <int D>
__host__ __device__ constexpr int panels() { return (D + 63) / 64; }

// Q, the ring of K and V tiles, the barriers, and slack to align the tiles
// to the 1024 bytes of a swizzle pattern; flash_attention.py's
// dynamic_smem_bytes repeats this sum.
template <int D, int DV>
constexpr size_t smem_bytes() {
  constexpr size_t DP = 64 * panels<D>();
  return 1024 + 2 * (static_cast<size_t>(BQ) * DP + static_cast<size_t>(stages<D, DV>()) * BK * (DP + DV)) +
         8 * (2 * stages<D, DV>() + 1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of the tensor map at (column c0, row c1, head c2) into shared
// memory; its bytes complete a transaction of the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
// Returns once at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory"); }

// Keeps the compiler from moving a register's reads or writes across the
// asynchronous wgmma that owns it.
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// Shared-memory matrix descriptor of a 128-byte-swizzled operand whose rows
// are 128 bytes apart and whose 8-row groups are 1024 bytes apart (stride
// offset). The leading offset is set to the same 1024 bytes: a K-major
// operand ignores it, and an MN-major one only 64 columns wide never uses it.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d (64 x 64, f32) = a (64 x 16) b (16 x 64) + (accumulate ? d : 0), both
// bf16 operands K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += a (64 x 16, bf16 fragment in registers) b (16 x 64),
// b MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(x[i]);
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(x[i]);
}

template <int N, int M>
__device__ __forceinline__ void pin(float (&x)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(x[i]);
}

// d (64 x 128, f32) = a (64 x 16) b (16 x 128) + (accumulate ? d : 0), both
// bf16 operands K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]),
        "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// S = Q K^T for one tile of N keys (64 or 128) in d / 16 steps of 16 columns
// (32 bytes of a 128-byte row; a new 64-column panel every four steps; at d
// 96 the second panel's zero half is never read).
template <int D, int N = BK>
__device__ __forceinline__ void mma_qk(float (&s)[N / 2], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = 32 * (kk % 4);
    const uint64_t a = desc(q_rows + (kk / 4) * BQ * ROW_BYTES + off);
    const uint64_t b = desc(k_tile + (kk / 4) * N * ROW_BYTES + off);
    if constexpr (N == 128)
      wgmma_ss_n128(s, a, b, kk > 0);
    else
      wgmma_ss(s, a, b, kk > 0);
  }
}

// O += P_hi V + P_lo V for one tile of N keys, 16 keys (2048 bytes) a step,
// one 64-column panel of V and of acc at a time.
template <int DV, int N = BK>
__device__ __forceinline__ void mma_pv(float (&acc)[DV / 64][32], const uint32_t (&p_hi)[N / 4],
                                         const uint32_t (&p_lo)[N / 4], uint32_t v_tile) {
#pragma unroll
  for (int c = 0; c < DV / 64; ++c) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t vd = desc(v_tile + c * N * ROW_BYTES + kk * 16 * ROW_BYTES);
      wgmma_rs(acc[c], p_hi + 4 * kk, vd);
      wgmma_rs(acc[c], p_lo + 4 * kk, vd);
    }
  }
}

// 2^x on the special-function unit; results below 2^-126 flush to zero,
// which no sum of weights that holds a 1 can see.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online-softmax step on the thread's S fragment of NS entries
// (32 for 64 keys, 64 for 128; rows row0 and row0 + 8, keys k0 + 8 j + {0,
// 1}): the scale, the cap and, on a tile that straddles an edge, the masks,
// in the plain version's order; the running max m; p = exp(s - m) in place;
// the thread's share of l. corr is the factor that rescales acc. Scores and m
// are kept in units of log2(e), so that p is one subtraction and one exp2.
template <int NS = 32>
__device__ __forceinline__ void softmax_step(float (&s)[NS], float (&m)[2], float (&l)[2], float (&corr)[2],
                                             int row0, int k0, bool edge, int Skv, int causal, int window,
                                             float scale, float logit_cap) {
  constexpr float LOG2E = 1.4426950408889634f;
  if (logit_cap > 0.f) {
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = logit_cap * tanhf(s[i] * scale / logit_cap) * LOG2E;
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] *= scale * LOG2E;
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int q = row0 + 8 * ((i / 2) % 2);
      const int k = k0 + 8 * (i / 4) + i % 2;
      if (k >= Skv)
        s[i] = -INFINITY;  // no key: weight 0 even in a row with nothing to attend
      else if ((causal && k > q) || (window > 0 && q - k >= window))
        s[i] = NEG_INF;
    }
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i / 2) % 2;
    s[i] = exp2_approx(s[i] - m[r]);
    l[r] += s[i];
  }
}

// P as bf16 hi + lo parts: the S fragment's pairs are the A fragment's.
template <int NS = 32>
__device__ __forceinline__ void split_p(const float (&s)[NS], uint32_t (&p_hi)[NS / 2], uint32_t (&p_lo)[NS / 2]) {
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
    const float2 back = __bfloat1622float2(hi);
    p_hi[i] = bits(hi);
    p_lo[i] = bits(__floats2bfloat162_rn(s[2 * i] - back.x, s[2 * i + 1] - back.y));
  }
}

// Thread t of a consumer warpgroup holds, in the fragment of a 64 x 64 f32
// wgmma result, entry i at row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2)
// and column 8 * (i / 4) + 2 * (t % 4) + i % 2.
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_bf16_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int Hq,
                       int Hkv, int Sq, int Skv, float scale, int causal, int window, float logit_cap) {
  constexpr int STAGES = stages<D, DV>();
  constexpr uint32_t Q_PANEL = BQ * ROW_BYTES;  // 64 columns of the Q tile
  constexpr uint32_t KV_PANEL = BK * ROW_BYTES;  // 64 columns of a K or V tile
  constexpr uint32_t Q_BYTES = panels<D>() * Q_PANEL;
  constexpr uint32_t K_BYTES = panels<D>() * KV_PANEL;
  constexpr uint32_t V_BYTES = (DV / 64) * KV_PANEL;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + Q_BYTES;           // STAGES K tiles
  const uint32_t sv = sk + STAGES * K_BYTES;  // STAGES V tiles
  const uint32_t q_full = sv + STAGES * V_BYTES;
  const uint32_t full = q_full + 8;           // STAGES barriers: the tile has landed
  const uint32_t empty = full + 8 * STAGES;   // STAGES barriers: both consumers are done with it

  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  // Tile liveness of the block, as in _attn_kernel: causal kills the tiles
  // right of its last row, the window (with causal) those left of its first
  // row's reach.
  const int n_k = (Skv + BK - 1) / BK;
  int kt_end = n_k;
  if (causal) kt_end = min(n_k, (min(q_start + BQ, Sq) - 1) / BK + 1);
  int kt_begin = 0;
  if (causal && window > 0 && q_start - window + 1 > 0) kt_begin = (q_start - window + 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // Producer: one thread keeps the ring full.
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      const int bh_kv = b * Hkv + hk;
      mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
      for (int c = 0; c < panels<D>(); ++c) tma_load(sq + c * Q_PANEL, &tm_q, q_full, 64 * c, q_start, b * Hq + h);
      int stage = 0, round = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, K_BYTES + V_BYTES);
#pragma unroll
        for (int c = 0; c < panels<D>(); ++c)
          tma_load(sk + stage * K_BYTES + c * KV_PANEL, &tm_k, bar, 64 * c, kt * BK, bh_kv);
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
          tma_load(sv + stage * V_BYTES + c * KV_PANEL, &tm_v, bar, 64 * c, kt * BK, bh_kv);
        if (++stage == STAGES) {
          stage = 0;
          ++round;
        }
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q_start + 64 wg .. + 63.
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int first = q_start + 64 * wg;        // this warpgroup's first row
    const int last = min(first + 63, Sq - 1);  // and its last row that exists
    const int row0 = first + 16 * (t / 32) + lane / 4;  // the thread's rows: row0, row0 + 8
    const int col0 = 2 * (lane % 4);

    // The tiles this warpgroup computes: a run [live_begin, live_end) of the
    // block's, by the same tests on its own rows. It only passes the others on.
    int live_begin = kt_begin, live_end = kt_end;
    if (causal) live_end = min(live_end, last / BK + 1);
    if (causal && window > 0 && first - window + 1 > 0) live_begin = max(live_begin, (first - window + 1) / BK);
    live_begin = min(live_begin, kt_end);
    if (first >= Sq || live_end < live_begin) live_end = live_begin;

    float acc[DV / 64][32];
#pragma unroll
    for (int c = 0; c < DV / 64; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    uint32_t p_hi[16], p_lo[16];
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float corr[2];

    const uint32_t q_rows = sq + 64 * wg * ROW_BYTES;
    int stage = 0, round = 0;
    auto advance = [&] {
      if (++stage == STAGES) {
        stage = 0;
        ++round;
      }
    };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    };
    auto pass = [&] {
      mbar_wait(full + 8 * stage, round & 1);
      release(stage);
      advance();
    };

    mbar_wait(q_full, 0);
    for (int kt = kt_begin; kt < live_begin; ++kt) pass();
    for (int kt = live_begin; kt < live_end; ++kt) {
      mbar_wait(full + 8 * stage, round & 1);
      wgmma_fence();
      mma_qk<D>(s, q_rows, sk + stage * K_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      const int k_start = kt * BK;
      const bool edge = k_start + BK > Skv || (causal && k_start + BK - 1 > first) ||
                        (window > 0 && first + 63 - k_start >= window);
      softmax_step(s, m, l, corr, row0, k_start + col0, edge, Skv, causal, window, scale, logit_cap);
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {  // a row's max moved
#pragma unroll
        for (int c = 0; c < DV / 64; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[c][i] *= corr[(i / 2) % 2];
      }
      split_p(s, p_hi, p_lo);
      wgmma_fence();
      mma_pv<DV>(acc, p_hi, p_lo, sv + stage * V_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      pin(p_hi);
      pin(p_lo);
      release(stage);
      advance();
    }
    for (int kt = live_end; kt < kt_end; ++kt) pass();

    // out = acc / max(l, 1e-30) in bf16, rows past Sq not stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = row0 + 8 * r;
      if (q >= Sq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = o + ((static_cast<size_t>(b) * Hq + h) * Sq + q) * DV + col0;
#pragma unroll
      for (int c = 0; c < DV / 64; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * c + 8 * j) =
              __floats2bfloat162_rn(acc[c][4 * j + 2 * r] / denom, acc[c][4 * j + 2 * r + 1] / denom);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that PyTorch has loaded (the
// library links no libcuda stub).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// Tensor map of a contiguous (heads, rows, cols) bf16 or f32 array, boxes of
// 128 bytes of columns (64 bf16, 32 f32) by box_rows rows, 128-byte swizzle,
// zeros outside the array (rows past S, columns past d 96); or boxes of
// box_cols columns under another swizzle (V^T's 16 keys, 64-byte swizzle).
int encode(CUtensorMap* map, const void* ptr, int heads, int rows, int cols, int box_rows, bool f32,
           int box_cols = 0, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return ENCODE_ERROR_BASE + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t size = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * size, static_cast<cuuint64_t>(rows) * cols * size};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols ? box_cols : ROW_BYTES / size),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR_BASE + static_cast<int>(r);
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq, int Skv,
           int causal, int window, float logit_cap, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorMisalignedAddress;  // a tensor map's base is 16-byte aligned
  CUtensorMap tq, tk, tv;
  if (int err = encode(&tq, q, B * Hq, Sq, D, BQ, false)) return err;
  if (int err = encode(&tk, k, B * Hkv, Skv, D, BK, false)) return err;
  if (int err = encode(&tv, v, B * Hkv, Skv, DV, BK, false)) return err;
  constexpr size_t smem = smem_bytes<D, DV>();
  auto kernel = flash_attn_bf16_kernel<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kernel<<<grid, THREADS, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv, scale,
                                          causal, window, logit_cap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at (d, dv) = (96, 64), MLA's prefill: the softmax under the products
// ---------------------------------------------------------------------------

constexpr int MLA_D = 96, MLA_DV = 64;
constexpr int MLA_PANELS = panels<MLA_D>();  // Q and K tiles: two 64-column panels
constexpr int MLA_BK = 128;     // keys per tile
constexpr int MLA_STAGES = 3;   // ring stages
constexpr int TURN_BAR = 1;     // named barriers TURN_BAR + wg: wg's turn to issue products

// Q, the ring of K and V tiles, the barriers and the alignment slack, as
// smem_bytes; flash_attention.py's dynamic_smem_bytes repeats this sum.
constexpr size_t mla_smem_bytes() {
  return 1024 + 2 * (static_cast<size_t>(BQ) * 64 * MLA_PANELS +
                     static_cast<size_t>(MLA_STAGES) * MLA_BK * (64 * MLA_PANELS + MLA_DV)) +
         8 * (2 * MLA_STAGES + 1);
}

// Named barriers of two warpgroups (256 threads): bar_sync waits for the
// other warpgroup's bar_arrive on the same id.
__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id) { asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory"); }

// A block as flash_attn_bf16_kernel's (128 query rows of one (b, hq), a
// producer warpgroup, two consumer warpgroups of 64 rows), with MLA_BK-key
// tiles. Each consumer walks the block's tiles kt_begin .. kt_end - 1 and
// takes one turn per tile plus one: in turn kt it issues S_kt = Q K_kt^T if
// tile kt is live for its rows and O += P_{kt-1} V_{kt-1} if tile kt - 1 was,
// hands the turn over, then waits for them, runs the softmax on S_kt,
// releases tile kt - 1's stage, rescales O and splits P_kt. A tile that is
// not live is only passed on. Both consumers take kt_end - kt_begin + 1 turns, whatever their live
// tiles, so every bar_sync meets its bar_arrive: warpgroup 1 arrives once
// before its first turn (warpgroup 0 goes first) and not after its last.
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_bf16_mla_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int Hq,
                           int Hkv, int Sq, int Skv, float scale, int causal, int window, float logit_cap) {
  constexpr int N = MLA_BK, NS = N / 2, STAGES = MLA_STAGES;
  constexpr uint32_t Q_PANEL = BQ * ROW_BYTES;
  constexpr uint32_t KV_PANEL = N * ROW_BYTES;
  constexpr uint32_t Q_BYTES = MLA_PANELS * Q_PANEL;
  constexpr uint32_t K_BYTES = MLA_PANELS * KV_PANEL;
  constexpr uint32_t V_BYTES = KV_PANEL;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + Q_BYTES;
  const uint32_t sv = sk + STAGES * K_BYTES;
  const uint32_t q_full = sv + STAGES * V_BYTES;
  const uint32_t full = q_full + 8;
  const uint32_t empty = full + 8 * STAGES;

  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  const int n_k = (Skv + N - 1) / N;
  int kt_end = n_k;
  if (causal) kt_end = min(n_k, (min(q_start + BQ, Sq) - 1) / N + 1);
  int kt_begin = 0;
  if (causal && window > 0 && q_start - window + 1 > 0) kt_begin = (q_start - window + 1) / N;
  kt_begin = min(kt_begin, kt_end);  // a window past a short Skv: no tile, one turn

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      const int bh_kv = b * Hkv + hk;
      mbar_expect_tx(q_full, Q_BYTES);
#pragma unroll
      for (int c = 0; c < MLA_PANELS; ++c) tma_load(sq + c * Q_PANEL, &tm_q, q_full, 64 * c, q_start, b * Hq + h);
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int i = kt - kt_begin, stage = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * stage, (i / STAGES - 1) & 1);
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, K_BYTES + V_BYTES);
#pragma unroll
        for (int c = 0; c < MLA_PANELS; ++c)
          tma_load(sk + stage * K_BYTES + c * KV_PANEL, &tm_k, bar, 64 * c, kt * N, bh_kv);
        tma_load(sv + stage * V_BYTES, &tm_v, bar, 0, kt * N, bh_kv);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int first = q_start + 64 * wg;
    const int last = min(first + 63, Sq - 1);
    const int row0 = first + 16 * (t / 32) + lane / 4;
    const int col0 = 2 * (lane % 4);

    int live_begin = kt_begin, live_end = kt_end;
    if (causal) live_end = min(live_end, last / N + 1);
    if (causal && window > 0 && first - window + 1 > 0) live_begin = max(live_begin, (first - window + 1) / N);
    live_begin = min(live_begin, kt_end);
    if (first >= Sq || live_end < live_begin) live_end = live_begin;

    float acc[1][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[0][i] = 0.f;
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    uint32_t p_hi[NS / 2], p_lo[NS / 2];
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};
    float corr[2];
    const uint32_t q_rows = sq + 64 * wg * ROW_BYTES;

    auto stage_of = [&](int kt) { return (kt - kt_begin) % STAGES; };
    auto wait_full = [&](int kt) {
      if (kt < kt_end) mbar_wait(full + 8 * stage_of(kt), ((kt - kt_begin) / STAGES) & 1);
    };
    auto release = [&](int kt) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage_of(kt));
    };
    auto take_turn = [&] { bar_sync(TURN_BAR + wg); };
    auto hand_over = [&](int kt) {
      if (wg == 0 || kt < kt_end) bar_arrive(TURN_BAR + 1 - wg);
    };
    auto pass = [&](int kt) {  // a turn without products
      wait_full(kt);
      take_turn();
      hand_over(kt);
      if (kt < kt_end) release(kt);
    };
    auto issue_s = [&](int kt) {
      // Q's six descriptors are recomputed here, not kept across the loop
      // (12 registers that spilled)
      uint32_t q = q_rows;
      asm volatile("" : "+r"(q));
      mma_qk<MLA_D, N>(s, q, sk + stage_of(kt) * K_BYTES);
      wgmma_commit();
    };
    auto issue_pv = [&](int kt) {
      mma_pv<MLA_DV, N>(acc, p_hi, p_lo, sv + stage_of(kt) * V_BYTES);
      wgmma_commit();
    };
    auto softmax = [&](int kt) {
      pin(s);
      const int k_start = kt * N;
      const bool edge = k_start + N > Skv || (causal && k_start + N - 1 > first) ||
                        (window > 0 && first + 63 - k_start >= window);
      softmax_step(s, m, l, corr, row0, k_start + col0, edge, Skv, causal, window, scale, logit_cap);
    };
    auto pv_done = [&](int kt) {
      pin(acc);
      pin(p_hi);
      pin(p_lo);
      release(kt);
    };
    auto make_p = [&] {
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {  // a row's max moved
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[0][i] *= corr[(i / 2) % 2];
      }
      split_p(s, p_hi, p_lo);
    };

    if (wg == 1) bar_arrive(TURN_BAR);  // warpgroup 0 takes the first turn
    mbar_wait(q_full, 0);
    int kt = kt_begin;
    for (; kt < live_begin; ++kt) pass(kt);
    if (live_begin < live_end) {
      wait_full(kt);  // the first live tile: S alone
      take_turn();
      wgmma_fence();
      issue_s(kt);
      hand_over(kt);
      wgmma_wait<0>();
      softmax(kt);
      make_p();
      for (++kt; kt < live_end; ++kt) {
        wait_full(kt);
        take_turn();
        wgmma_fence();
        issue_s(kt);
        issue_pv(kt - 1);
        hand_over(kt);
        wgmma_wait<1>();  // S_kt (ptxas moves the wait for P V up to here: see the header)
        softmax(kt);
        wgmma_wait<0>();
        pv_done(kt - 1);
        make_p();
      }
      wait_full(kt);  // turn live_end: the last live tile's P V
      take_turn();
      wgmma_fence();
      issue_pv(kt - 1);
      hand_over(kt);
      wgmma_wait<0>();
      pv_done(kt - 1);
      if (kt < kt_end) release(kt);
      ++kt;
    }
    for (; kt <= kt_end; ++kt) pass(kt);

    // out = acc / max(l, 1e-30) in bf16, rows past Sq not stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = row0 + 8 * r;
      if (q >= Sq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = o + ((static_cast<size_t>(b) * Hq + h) * Sq + q) * MLA_DV + col0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[0][4 * j + 2 * r] / denom, acc[0][4 * j + 2 * r + 1] / denom);
    }
  }
}

int launch_mla(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq, int Skv,
               int causal, int window, float logit_cap, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv;
  if (int err = encode(&tq, q, B * Hq, Sq, MLA_D, BQ, false)) return err;
  if (int err = encode(&tk, k, B * Hkv, Skv, MLA_D, MLA_BK, false)) return err;
  if (int err = encode(&tv, v, B * Hkv, Skv, MLA_DV, MLA_BK, false)) return err;
  constexpr size_t smem = mla_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(flash_attn_bf16_mla_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(MLA_D));
  flash_attn_bf16_mla_kernel<<<grid, THREADS, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hkv,
                                                              Sq, Skv, scale, causal, window, logit_cap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores as 3xTF32: every pair, (256, 256) on a cluster
// ---------------------------------------------------------------------------

constexpr int T_STAGES = 2;          // stages of the ring where the block splits K and V
constexpr int SPLITTERS = 3;         // producer warps that split K and V
constexpr int TF32_MLA_BK = 32;      // keys a tile at (96, 64)
constexpr int TF32_PRESPLIT_BK = 16; // keys a tile where K and V come split
constexpr int TF32_MIXED_BK = 32;    // but at (64, 128) and (128, 64), whose 32-key stages fit
constexpr int PRESPLIT_STAGES = 3;   // stages of the ring where K and V come split, or two where three do not fit
constexpr int CLUSTER_STAGES = 2;    // stages at (256, 256), beside the cluster's exchange slots
constexpr int SPLIT_KEYS = 32;       // keys a block of the split kernel; V^T's keys are padded to it
constexpr size_t MAX_SMEM = 232448;  // the shared memory a Hopper block may opt into

// The f32 pairs of the TF32 kernels: every pair of the wrapper's HEAD_DIM_PAIRS.
template <int D, int DV>
__host__ __device__ constexpr bool tf32_pair() {
  return (D == 64 && DV == 64) || (D == MLA_D && DV == MLA_DV) || (D == 128 && DV == 128) ||
         (D == 64 && DV == 128) || (D == 128 && DV == 64) || (D == 256 && DV == 256);
}
// The pairs with a head dim of 128 or more read K and V split once per call
// into global memory by tf32_split_kv_kernel, at 16-key tiles (32 at the
// mixed pairs); (64, 64) and (96, 64) split each tile in the block.
template <int D, int DV>
__host__ __device__ constexpr bool tf32_presplit() { return D >= 128 || DV >= 128; }
template <int D, int DV>
__host__ __device__ constexpr int tf32_bk() {
  if (D == MLA_D) return TF32_MLA_BK;
  if (D != DV) return TF32_MIXED_BK;
  return tf32_presplit<D, DV>() ? TF32_PRESPLIT_BK : BK;
}
// Blocks of a cluster that split the head dims between them: two at
// (256, 256), each with the columns of a (128, 128) block.
template <int D, int DV>
__host__ __device__ constexpr int tf32_cluster() { return D == 256 ? 2 : 1; }

// The tiles of the TF32 kernel at (D, DV) with TBK keys a tile. A block holds
// DL = D / CLUSTER columns of Q and K and DVL = DV / CLUSTER of V and O. A
// 128-byte swizzled row holds 32 f32 columns, so Q (128 rows), K and V (TBK
// rows each) are panels of 32 columns, d 96 exactly three; V^T has DVL rows,
// one for each output column, and TBK / 32 panels of keys, or at 16 keys rows
// of 64 bytes with the 64-byte swizzle (vt_desc).
template <int D, int DV, int TBK>
struct Tf32Tiles {
  static constexpr int CLUSTER = tf32_cluster<D, DV>();
  static constexpr int DL = D / CLUSTER, DVL = DV / CLUSTER;
  static constexpr bool PRESPLIT = tf32_presplit<D, DV>();
  static constexpr uint32_t Q_PANEL = BQ * ROW_BYTES;
  static constexpr uint32_t KV_PANEL = TBK * ROW_BYTES;
  static constexpr uint32_t Q_BYTES = (DL / 32) * Q_PANEL;
  static constexpr uint32_t K_BYTES = (DL / 32) * KV_PANEL;
  static constexpr uint32_t V_BYTES = (DVL / 32) * KV_PANEL;  // V as loaded; V^T_hi and V^T_lo as much
  // A stage: K_hi (K as loaded, split in place, or loaded split), K_lo, V as
  // loaded (not when it comes split), V^T_hi and V^T_lo; V^T_hi at VT.
  static constexpr uint32_t VT = 2 * K_BYTES + (PRESPLIT ? 0 : V_BYTES);
  static constexpr uint32_t STAGE = VT + 2 * V_BYTES;
  // the bytes TMA brings into a stage
  static constexpr uint32_t LOADED = PRESPLIT ? STAGE : K_BYTES + V_BYTES;
  // In a cluster, each consumer warpgroup sends its partial S (64 rows x TBK
  // keys over the block's DL columns) into one of two slots of the peer
  // block, by the tile's parity, and receives the peer's in its own.
  static constexpr uint32_t SLOT = 64 * TBK * 4;
  static constexpr uint32_t EXCHANGE = CLUSTER > 1 ? CONSUMERS * 2 * SLOT : 0;
  // Q as loaded (split in place into Q_hi) and Q_lo, the exchange slots, a
  // barrier for Q and in a cluster one per exchange slot (landed), and slack
  // to align the tiles to the 1024 bytes of a swizzle pattern; then per stage
  // its tiles and its barriers full, ready (not when K and V come split) and
  // empty. The ring has three stages where K and V come split, or two where
  // three do not fit; flash_attention.py's dynamic_smem_bytes repeats this.
  static constexpr size_t FIXED = 1024 + 2 * Q_BYTES + EXCHANGE + 8 * (1 + (CLUSTER > 1 ? CONSUMERS * 2 : 0));
  static constexpr size_t PER_STAGE = STAGE + 8 * (PRESPLIT ? 2 : 3);
  static constexpr int STAGES = CLUSTER > 1 ? CLUSTER_STAGES
                                : !PRESPLIT ? T_STAGES
                                : FIXED + PRESPLIT_STAGES * PER_STAGE <= MAX_SMEM ? PRESPLIT_STAGES
                                : PRESPLIT_STAGES - 1;
  static constexpr size_t SMEM = FIXED + STAGES * PER_STAGE;
  static_assert(DL % 32 == 0 && DVL % 64 == 0 && (TBK == 16 || TBK == 32 || TBK == 64),
                "S is m64n{16,32,64}, P V m64n64 a 64-column half of O");
  static_assert(CLUSTER == 1 || (PRESPLIT && TBK == 16), "a cluster's blocks read K and V split, 16 keys a tile");
  static_assert(SMEM <= MAX_SMEM, "a Hopper block opts into at most 232,448 bytes");
};

// Byte offset of f32 element (row, col) in a tile kept as panels of 32
// columns, panel_bytes apart, each row 128 bytes with the 128-byte swizzle
// (TMA's and wgmma's): the row's 16-byte chunk c sits at chunk c ^ (row % 8).
__device__ __forceinline__ uint32_t swz(int row, int col, uint32_t panel_bytes) {
  return (col / 32) * panel_bytes + row * ROW_BYTES + ((((col % 32) / 4) ^ (row % 8)) << 4) + (col % 4) * 4;
}

// The blocks of a cluster (tf32_cluster): this block's rank, the address in
// the shared memory of block `rank` that matches a local one, a 16-byte store
// there, an arrival on a barrier there that releases this thread's earlier
// accesses to the cluster, a wait on a local barrier that acquires them, and
// a barrier of every thread of the cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t peer_addr(uint32_t local, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_peer(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_peer(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(addr) : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;" ::: "memory");
}

// Round to TF32 (to nearest, ties away from zero), the 13 low bits cleared
// here rather than left to how wgmma reads them.
__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xFFFFE000u);
}

// d (64 x N, f32: the first N / 2 entries) = a (64 x 8) b (8 x N) +
// (accumulate ? d : 0), N 64, 32 or 16, tf32, both K-major in shared memory (tf32
// has no transpose).
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float* d, uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    static_assert(N == 16, "m64n16k8, m64n32k8 or m64n64k8");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// d (64 x 64, f32) = a (64 x 8, tf32 fragment in registers) b (8 x 64) +
// (accumulate ? d : 0), b K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// Descriptor of k-step kk (8 columns, 32 bytes) of a K-major tile whose
// 32-column panels are panel_bytes apart.
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int kk, uint32_t panel_bytes) {
  return desc(tile + (kk / 4) * panel_bytes + 32 * (kk % 4));
}

// Descriptor of k-step kk of the 64-column half c of a V^T tile: at 16 keys
// (rows of 64 bytes, as TMA's 64-byte swizzle lays them out: a row's 16-byte
// chunk j at j ^ ((row / 2) % 4)) a 64-byte-swizzled operand (layout type 2)
// whose 8-row groups are 512 bytes apart, the k-step 32 bytes into each row;
// else panels of 32 keys as swz.
template <int DV, int TBK>
__device__ __forceinline__ uint64_t vt_desc(uint32_t vt, int c, int kk) {
  if constexpr (TBK == 16) {
    const uint32_t addr = vt + c * 64 * 64 + 32 * kk;
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
           (static_cast<uint64_t>(512 >> 4) << 32) | (static_cast<uint64_t>(2) << 62);
  } else {
    return tile_desc(vt + c * 64 * ROW_BYTES, kk, DV * ROW_BYTES);
  }
}

// Key of column c of V^T: the 8 keys of each group are ordered 0 2 4 6 1 3 5 7,
// so that a thread's S fragment (keys 2t, 2t + 1 of each group) is its P
// fragment (A columns t, t + 4) as it stands.
__device__ __forceinline__ int vt_key(int c) {
  const int j = c % 8;
  return (c - j) + (j < 4 ? 2 * j : 2 * (j - 4) + 1);
}

// One stage, by the splitter warps (thread i of n): K_hi = tf32(K) in place
// and K_lo = tf32(K - K_hi) at the same swizzled offsets; V^T_hi and V^T_lo,
// transposed, keys in vt_key order, in the swizzled K-major layout.
template <int D, int DV, int TBK>
__device__ __forceinline__ void split_stage(uint32_t stage_base, int i, int n) {
  using T = Tf32Tiles<D, DV, TBK>;
  uint8_t* base = reinterpret_cast<uint8_t*>(__cvta_shared_to_generic(stage_base));
  float4* k = reinterpret_cast<float4*>(base);
  float4* k_lo = reinterpret_cast<float4*>(base + T::K_BYTES);
  const uint8_t* v = base + 2 * T::K_BYTES;
  uint8_t* vt_hi = base + 2 * T::K_BYTES + T::V_BYTES;
  uint8_t* vt_lo = vt_hi + T::V_BYTES;
  for (int j = i; j < static_cast<int>(T::K_BYTES / 16); j += n) {
    const float4 x = k[j];
    const float4 hi = make_float4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z), to_tf32(x.w));
    k[j] = hi;
    k_lo[j] = make_float4(to_tf32(x.x - hi.x), to_tf32(x.y - hi.y), to_tf32(x.z - hi.z), to_tf32(x.w - hi.w));
  }
  // V^T row r (an output column) and columns 4 q .. 4 q + 3: consecutive
  // threads take consecutive rows, so the reads of a V row and the 16-byte
  // writes meet no bank twice
  for (int j = i; j < DV * (TBK / 4); j += n) {
    const int r = j % DV, q = j / DV;
    float hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = *reinterpret_cast<const float*>(v + swz(vt_key(4 * q + e), r, T::KV_PANEL));
      hi[e] = to_tf32(x);
      lo[e] = to_tf32(x - hi[e]);
    }
    const uint32_t off = swz(r, 4 * q, DV * ROW_BYTES);
    *reinterpret_cast<float4*>(vt_hi + off) = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(vt_lo + off) = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The block of a TF32 kernel: 128 query rows of one (b, hq), as the bf16
// kernel, with the split of each operand into TF32 hi and lo parts:
// - producer warp 0, one thread: TMA of Q once and of K and V tiles of TBK
//   keys into the ring (stage full); warps 1 to 3 split each landed stage
//   (stage ready). When K and V come split (tf32_presplit), the thread loads
//   K_hi, K_lo (tm_k, tm_k_lo), V^T_hi and V^T_lo (tm_v, tm_v_lo) instead, a
//   landed stage is ready, and warps 1 to 3 have nothing to do;
// - two consumer warpgroups: each pre-scales its 64 rows of Q in f32 and
//   splits them in shared memory once; per live tile S = Q_hi K_hi +
//   (Q_hi K_lo + Q_lo K_hi), each a run of DL / 8 wgmma m64nTBKk8, and O +=
//   P_hi V_hi + (P_hi V_lo + P_lo V_hi), each a run of TBK / 8 wgmma m64n64k8
//   for each 64-column half of O in turn, the online softmax as in the bf16
//   kernel, then the stage is released (stage empty).
// In a cluster (tf32_cluster: (256, 256)) the two blocks own the same 128
// rows, block r columns [DL r, DL r + DL) of Q and K and [DVL r, DVL r + DVL)
// of V and O. Each consumer warpgroup sums its partial S (large and small
// products) over the block's DL columns, stores it into the peer block's slot
// of the tile's parity and arrives on the peer's barrier of that slot, then
// waits on its own and adds the peer's partial: both blocks then hold the same
// S (f32 addition commutes), so the same m, l, P and rescale votes, and each
// multiplies P by its own columns of V. A slot is written again two live tiles
// later, after its reader's partial for the tile between has arrived, which
// that reader sends only after reading the slot: no barrier frees it.
template <int D, int DV, int TBK>
__device__ __forceinline__ void tf32_block(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                           const CUtensorMap& tm_v, const CUtensorMap& tm_k_lo,
                                           const CUtensorMap& tm_v_lo, float* __restrict__ o, int Hq, int Hkv,
                                           int Sq, int Skv, float scale, int causal, int window, float logit_cap) {
  using T = Tf32Tiles<D, DV, TBK>;
  constexpr int NS = TBK / 2;  // a thread's entries of S
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;  // Q, then Q_hi
  const uint32_t sq_lo = sq + T::Q_BYTES;
  const uint32_t ring = sq_lo + T::Q_BYTES;         // T::STAGES stages of T::STAGE bytes
  const uint32_t exch = ring + T::STAGES * T::STAGE;  // the cluster's exchange slots
  const uint32_t q_full = exch + T::EXCHANGE;
  const uint32_t full = q_full + 8;                 // K and V have landed
  // the stage is split (a landed stage, when K and V come split)
  const uint32_t ready = T::PRESPLIT ? full : full + 8 * T::STAGES;
  const uint32_t empty = ready + 8 * T::STAGES;     // both consumers are done with it
  const uint32_t landed = empty + 8 * T::STAGES;    // the peer's partial S is in the slot
  const int rank = T::CLUSTER > 1 ? static_cast<int>(cluster_rank()) : 0;

  const int q_start = (gridDim.x / T::CLUSTER - 1 - blockIdx.x / T::CLUSTER) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  const int n_k = (Skv + TBK - 1) / TBK;
  int kt_end = n_k;
  if (causal) kt_end = min(n_k, (min(q_start + BQ, Sq) - 1) / TBK + 1);
  int kt_begin = 0;
  if (causal && window > 0 && q_start - window + 1 > 0) kt_begin = (q_start - window + 1) / TBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      if (!T::PRESPLIT) mbar_init(ready + 8 * s, SPLITTERS);
      mbar_init(empty + 8 * s, CONSUMERS * 4);
    }
    for (int s = 0; s < (T::CLUSTER > 1 ? CONSUMERS * 2 : 0); ++s) mbar_init(landed + 8 * s, 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (T::CLUSTER > 1)
    cluster_sync();  // the peer's barriers are set up before anything arrives on them
  else
    __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    setmaxnreg_dec<40>();
    const int warp = (threadIdx.x % 128) / 32;
    if (warp == 0) {
      if (threadIdx.x == CONSUMERS * 128) {
        const int bh_kv = b * Hkv + hk;
        const int c0 = T::DL * rank;  // the block's first column of Q and K
        mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
        for (int c = 0; c < T::DL / 32; ++c)
          tma_load(sq + c * T::Q_PANEL, &tm_q, q_full, c0 + 32 * c, q_start, b * Hq + h);
        int stage = 0, round = 0;
        for (int kt = kt_begin; kt < kt_end; ++kt) {
          if (round > 0) mbar_wait(empty + 8 * stage, (round - 1) & 1);
          const uint32_t bar = full + 8 * stage, st = ring + stage * T::STAGE;
          mbar_expect_tx(bar, T::LOADED);
#pragma unroll
          for (int c = 0; c < T::DL / 32; ++c)
            tma_load(st + c * T::KV_PANEL, &tm_k, bar, c0 + 32 * c, kt * TBK, bh_kv);
          if constexpr (T::PRESPLIT) {
#pragma unroll
            for (int c = 0; c < T::DL / 32; ++c)
              tma_load(st + T::K_BYTES + c * T::KV_PANEL, &tm_k_lo, bar, c0 + 32 * c, kt * TBK, bh_kv);
            // V^T's boxes: TBK keys of the block's DVL rows (64-byte swizzle)
            tma_load(st + T::VT, &tm_v, bar, kt * TBK, T::DVL * rank, bh_kv);
            tma_load(st + T::VT + T::V_BYTES, &tm_v_lo, bar, kt * TBK, T::DVL * rank, bh_kv);
          } else {
#pragma unroll
            for (int c = 0; c < DV / 32; ++c)
              tma_load(st + 2 * T::K_BYTES + c * T::KV_PANEL, &tm_v, bar, 32 * c, kt * TBK, bh_kv);
          }
          if (++stage == T::STAGES) {
            stage = 0;
            ++round;
          }
        }
      }
    } else if constexpr (!T::PRESPLIT) {
      const int i = threadIdx.x % 128 - 32;
      int stage = 0, round = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(full + 8 * stage, round & 1);
        split_stage<D, DV, TBK>(ring + stage * T::STAGE, i, 32 * SPLITTERS);
        // the split parts are read by wgmma, through the async proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (i % 32 == 0) mbar_arrive(ready + 8 * stage);
        if (++stage == T::STAGES) {
          stage = 0;
          ++round;
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int first = q_start + 64 * wg;
    const int last = min(first + 63, Sq - 1);
    const int row0 = first + 16 * (t / 32) + lane / 4;
    const int col0 = 2 * (lane % 4);

    int live_begin = kt_begin, live_end = kt_end;
    if (causal) live_end = min(live_end, last / TBK + 1);
    if (causal && window > 0 && first - window + 1 > 0) live_begin = max(live_begin, (first - window + 1) / TBK);
    live_begin = min(live_begin, kt_end);
    if (first >= Sq || live_end < live_begin) live_end = live_begin;

    // This warpgroup's 64 rows of Q (rows past Sq are zeros), scaled in f32
    // and split: Q_hi in place, Q_lo at the same swizzled offsets
    mbar_wait(q_full, 0);
    {
      uint8_t* qs = reinterpret_cast<uint8_t*>(__cvta_shared_to_generic(sq));
      uint8_t* qs_lo = reinterpret_cast<uint8_t*>(__cvta_shared_to_generic(sq_lo));
      for (int j = t; j < 64 * T::DL / 4; j += 128) {  // 512 chunks of 16 bytes a panel of 64 rows
        const uint32_t off = (j / 512) * T::Q_PANEL + (64 * wg + (j / 8) % 64) * ROW_BYTES + 16 * (j % 8);
        float4 x = *reinterpret_cast<float4*>(qs + off);
        x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
        const float4 hi = make_float4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z), to_tf32(x.w));
        *reinterpret_cast<float4*>(qs + off) = hi;
        *reinterpret_cast<float4*>(qs_lo + off) =
            make_float4(to_tf32(x.x - hi.x), to_tf32(x.y - hi.y), to_tf32(x.z - hi.z), to_tf32(x.w - hi.w));
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");  // this warpgroup's rows are split
    }
    const uint32_t q_rows = sq + 64 * wg * ROW_BYTES, q_rows_lo = sq_lo + 64 * wg * ROW_BYTES;

    // The tensor cores round their f32 sums toward zero at each wgmma, so
    // products of unequal size go to separate accumulators, added once per
    // tile on the FMA units with rounding to nearest: s (Q_hi K_hi) and pv
    // (P_hi V_hi) take the large terms, small the hi-lo ones of either
    // product; acc carries O across tiles. S's small products go to an array
    // of S's shape: small itself at 64-key tiles (m64n64, as P V's), one of
    // their own at 32- and 16-key tiles (one array serving m64n32 and m64n64
    // products made ptxas serialise the wgmmas, warning C7511: 8% slower). At
    // DVL 128 acc holds both halves of O, and pv and small serve one half at a
    // time.
    float acc[T::DVL / 2], pv[32], small[32];
    float s[NS];  // S, then p, then P_lo
    float s_small_own[NS < 32 ? NS : 1];
    float* const s_small = NS < 32 ? s_small_own : small;
#pragma unroll
    for (int i = 0; i < 32; ++i) pv[i] = small[i] = 0.f;
#pragma unroll
    for (int i = 0; i < T::DVL / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = s_small[i] = 0.f;
    uint32_t p_hi[NS];
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};
    float corr[2];

    int stage = 0, round = 0;
    auto advance = [&] {
      if (++stage == T::STAGES) {
        stage = 0;
        ++round;
      }
    };
    auto release = [&] {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      advance();
    };
    for (int kt = kt_begin; kt < live_begin; ++kt) {
      mbar_wait(ready + 8 * stage, round & 1);
      release();
    }
    for (int kt = live_begin; kt < live_end; ++kt) {
      mbar_wait(ready + 8 * stage, round & 1);
      const uint32_t st = ring + stage * T::STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::DL / 8; ++kk) {
        const uint64_t k_hi = tile_desc(st, kk, T::KV_PANEL), k_lo = tile_desc(st + T::K_BYTES, kk, T::KV_PANEL);
        const uint32_t off = (kk / 4) * T::Q_PANEL + 32 * (kk % 4);
        const uint64_t a_hi = desc(q_rows + off), a_lo = desc(q_rows_lo + off);
        wgmma_tf32_ss<TBK>(s, a_hi, k_hi, kk > 0);
        wgmma_tf32_ss<TBK>(s_small, a_hi, k_lo, kk > 0);
        wgmma_tf32_ss<TBK>(s_small, a_lo, k_hi, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
#pragma unroll
      for (int i = 0; i < NS; ++i) pin(s_small[i]);
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] += s_small[i];
      if constexpr (T::CLUSTER > 1) {
        // thread t's float4 f of a slot at 2048 f + 16 t: a warp's stores and
        // loads are 512 contiguous bytes
        const int i = kt - live_begin, slot = 2 * wg + (i & 1);
        const uint32_t mine = exch + slot * T::SLOT + 16 * t, theirs = peer_addr(mine, rank ^ 1);
#pragma unroll
        for (int f = 0; f < NS / 4; ++f)
          st_peer(theirs + 2048 * f, s[4 * f], s[4 * f + 1], s[4 * f + 2], s[4 * f + 3]);
        mbar_arrive_peer(peer_addr(landed + 8 * slot, rank ^ 1));
        mbar_wait_cluster(landed + 8 * slot, (i >> 1) & 1);
        const uint8_t* got = reinterpret_cast<const uint8_t*>(__cvta_shared_to_generic(mine));
#pragma unroll
        for (int f = 0; f < NS / 4; ++f) {
          const float4 x = *reinterpret_cast<const float4*>(got + 2048 * f);
          s[4 * f] += x.x;
          s[4 * f + 1] += x.y;
          s[4 * f + 2] += x.z;
          s[4 * f + 3] += x.w;
        }
      }
      const int k_start = kt * TBK;
      const bool edge = k_start + TBK > Skv || (causal && k_start + TBK - 1 > first) ||
                        (window > 0 && first + 63 - k_start >= window);
      softmax_step(s, m, l, corr, row0, k_start + col0, edge, Skv, causal, window, 1.f, logit_cap);
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < T::DVL / 2; ++i) acc[i] *= corr[(i / 2) % 2];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float hi = to_tf32(s[i]);
        p_hi[i] = __float_as_uint(hi);
        s[i] = to_tf32(s[i] - hi);
      }
      const uint32_t vt = st + T::VT;  // V^T_hi, then V^T_lo
#pragma unroll
      for (int c = 0; c < T::DVL / 64; ++c) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TBK / 8; ++kk) {
          // A columns t, t + 4 are keys 2t, 2t + 1: entries 4kk, 4kk + 2 (rows
          // r, r + 8 of key 2t) and 4kk + 1, 4kk + 3 (key 2t + 1)
          const uint64_t v_hi = vt_desc<T::DVL, TBK>(vt, c, kk), v_lo = vt_desc<T::DVL, TBK>(vt + T::V_BYTES, c, kk);
          const uint32_t* a = p_hi + 4 * kk;
          const uint32_t b0 = __float_as_uint(s[4 * kk]), b1 = __float_as_uint(s[4 * kk + 1]),
                         b2 = __float_as_uint(s[4 * kk + 2]), b3 = __float_as_uint(s[4 * kk + 3]);
          wgmma_tf32_rs(pv, a[0], a[2], a[1], a[3], v_hi, kk > 0);
          wgmma_tf32_rs(small, a[0], a[2], a[1], a[3], v_lo, kk > 0);
          wgmma_tf32_rs(small, b0, b2, b1, b3, v_hi, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(pv);
        pin(small);
        pin(p_hi);
        pin(s);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[32 * c + i] += pv[i] + small[i];
      }
      release();
    }
    for (int kt = live_end; kt < kt_end; ++kt) {
      mbar_wait(ready + 8 * stage, round & 1);
      release();
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = row0 + 8 * r;
      if (q >= Sq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      float* orow = o + ((static_cast<size_t>(b) * Hq + h) * Sq + q) * DV + T::DVL * rank + col0;
#pragma unroll
      for (int j = 0; j < T::DVL / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(acc[4 * j + 2 * r] / denom,
                                                               acc[4 * j + 2 * r + 1] / denom);
    }
  }
  // no block of a cluster exits while its peer may still write its slots
  if constexpr (T::CLUSTER > 1) cluster_sync();
}

// nbi-100m's f32 heads, (64, 64), 64-key tiles.
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_tf32_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o, int Hq, int Hkv, int Sq,
                       int Skv, float scale, int causal, int window, float logit_cap) {
  tf32_block<64, 64, BK>(tm_q, tm_k, tm_v, tm_k, tm_v, o, Hq, Hkv, Sq, Skv, scale, causal, window, logit_cap);
}

// MLA's f32 heads, (96, 64), 32-key tiles.
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_tf32_mla_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o, int Hq, int Hkv,
                           int Sq, int Skv, float scale, int causal, int window, float logit_cap) {
  tf32_block<MLA_D, MLA_DV, TF32_MLA_BK>(tm_q, tm_k, tm_v, tm_k, tm_v, o, Hq, Hkv, Sq, Skv, scale, causal, window,
                                         logit_cap);
}

// The pairs whose K and V come split (tf32_presplit), at 16-key tiles: tm_k
// K_hi, tm_k_lo K_lo, tm_v V^T_hi, tm_v_lo V^T_lo (tf32_split_kv_kernel).
#define TF32_PRESPLIT_PARAMS                                                                                  \
  const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,                        \
      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_k_lo,                 \
      const __grid_constant__ CUtensorMap tm_v_lo, float *__restrict__ o, int Hq, int Hkv, int Sq, int Skv, \
      float scale, int causal, int window, float logit_cap
#define TF32_PRESPLIT_ARGS tm_q, tm_k, tm_v, tm_k_lo, tm_v_lo, o, Hq, Hkv, Sq, Skv, scale, causal, window, logit_cap

// f32 heads of 128, (128, 128): Q and Q_lo take 128 KB, so a stage of 32
// keys would not fit twice.
__global__ void __launch_bounds__(THREADS, 1) flash_attn_tf32_d128_kernel(TF32_PRESPLIT_PARAMS) {
  tf32_block<128, 128, tf32_bk<128, 128>()>(TF32_PRESPLIT_ARGS);
}

// (128, 64): the (128, 128) block with one 64-column half of O, at 32-key
// tiles in two stages.
__global__ void __launch_bounds__(THREADS, 1) flash_attn_tf32_d128_dv64_kernel(TF32_PRESPLIT_PARAMS) {
  tf32_block<128, 64, tf32_bk<128, 64>()>(TF32_PRESPLIT_ARGS);
}

// (64, 128): the (128, 128) block with Q and K two 32-column panels, at
// 32-key tiles in three stages.
__global__ void __launch_bounds__(THREADS, 1) flash_attn_tf32_d64_dv128_kernel(TF32_PRESPLIT_PARAMS) {
  tf32_block<64, 128, tf32_bk<64, 128>()>(TF32_PRESPLIT_ARGS);
}

// (256, 256): a cluster of two (128, 128) blocks over one 128-row query tile,
// each with half of the head dims, their partial S summed across the cluster.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
    flash_attn_tf32_d256_kernel(TF32_PRESPLIT_PARAMS) {
  tf32_block<256, 256, tf32_bk<256, 256>()>(TF32_PRESPLIT_ARGS);
}

template <int D, int DV>
constexpr auto presplit_kernel() {
  if constexpr (D == 256)
    return flash_attn_tf32_d256_kernel;
  else if constexpr (D == 128 && DV == 128)
    return flash_attn_tf32_d128_kernel;
  else if constexpr (D == 128)
    return flash_attn_tf32_d128_dv64_kernel;
  else
    return flash_attn_tf32_d64_dv128_kernel;
}

// K and V of one (b, hkv) split into TF32 hi and lo parts in global memory,
// SPLIT_KEYS keys a block: k_hi and k_lo in K's layout (Skv rows of D);
// v^T_hi and v^T_lo transposed, DV rows of keys_pad keys (Skv rounded up to
// SPLIT_KEYS, the keys past Skv zero), the keys of each group of 8 in vt_key
// order, as split_stage writes a tile of V^T. V goes through shared memory
// (rows padded by one float), so that both its reads and the V^T rows'
// writes are coalesced.
template <int D, int DV>
__global__ void __launch_bounds__(256)
tf32_split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ k_hi,
                     float* __restrict__ k_lo, float* __restrict__ vt_hi, float* __restrict__ vt_lo, int Skv,
                     int keys_pad) {
  __shared__ float sv[SPLIT_KEYS][DV + 1];
  const int bh = blockIdx.y, k0 = blockIdx.x * SPLIT_KEYS;
  const int keys = min(SPLIT_KEYS, Skv - k0);  // at least 1: k0 < Skv
  const size_t row0 = static_cast<size_t>(bh) * Skv + k0;
  const float4* k4 = reinterpret_cast<const float4*>(k + row0 * D);
  float4* hi4 = reinterpret_cast<float4*>(k_hi + row0 * D);
  float4* lo4 = reinterpret_cast<float4*>(k_lo + row0 * D);
  for (int j = threadIdx.x; j < keys * D / 4; j += blockDim.x) {
    const float4 x = k4[j];
    const float4 hi = make_float4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z), to_tf32(x.w));
    hi4[j] = hi;
    lo4[j] = make_float4(to_tf32(x.x - hi.x), to_tf32(x.y - hi.y), to_tf32(x.z - hi.z), to_tf32(x.w - hi.w));
  }
  for (int j = threadIdx.x; j < SPLIT_KEYS * DV; j += blockDim.x) {
    const int key = j / DV, col = j % DV;
    sv[key][col] = key < keys ? v[(row0 + key) * DV + col] : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < SPLIT_KEYS * DV; j += blockDim.x) {
    const int c = j % SPLIT_KEYS, r = j / SPLIT_KEYS;
    const float x = sv[vt_key(c)][r];
    const float hi = to_tf32(x);
    const size_t at = (static_cast<size_t>(bh) * DV + r) * keys_pad + k0 + c;
    vt_hi[at] = hi;
    vt_lo[at] = to_tf32(x - hi);
  }
}

// f32 the kernel at (D, DV) needs besides its output (flash_attention.py's
// workspace_floats repeats this): K_hi, K_lo, V^T_hi, V^T_lo when K and V
// come split, else none.
template <int D, int DV>
long long tf32_workspace_floats(int B, int Hkv, int Skv) {
  if constexpr (!tf32_presplit<D, DV>()) return 0;
  const long long keys_pad = (Skv + SPLIT_KEYS - 1) / SPLIT_KEYS * SPLIT_KEYS;
  return 2LL * B * Hkv * (static_cast<long long>(Skv) * D + static_cast<long long>(DV) * keys_pad);
}

// Clusters of the kernel at (D, DV) that the card can hold at once, its
// shared memory set; 0 when the kernel has no cluster.
template <int D, int DV>
int tf32_clusters_resident(int* out) {
  *out = 0;
  if constexpr (tf32_cluster<D, DV>() > 1) {
    auto kernel = presplit_kernel<D, DV>();
    constexpr size_t smem = Tf32Tiles<D, DV, tf32_bk<D, DV>()>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(tf32_cluster<D, DV>(), 1, 1);
    config.blockDim = dim3(THREADS, 1, 1);
    config.dynamicSmemBytes = smem;
    return cudaOccupancyMaxActiveClusters(out, kernel, &config);
  }
  return cudaSuccess;
}

template <int D, int DV>
int launch_tf32(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                int causal, int window, float logit_cap, float* ws, long long ws_floats, cudaStream_t stream) {
  static_assert(tf32_pair<D, DV>(), "a pair of HEAD_DIM_PAIRS");
  constexpr int TBK = tf32_bk<D, DV>();
  using T = Tf32Tiles<D, DV, TBK>;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorMisalignedAddress;
  constexpr size_t smem = T::SMEM;
  const dim3 grid(T::CLUSTER * ((Sq + BQ - 1) / BQ), Hq, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  CUtensorMap tq, tk, tv;
  if (int err = encode(&tq, q, B * Hq, Sq, D, BQ, true)) return err;
  if constexpr (T::PRESPLIT) {
    if (ws == nullptr || ws_floats < tf32_workspace_floats<D, DV>(B, Hkv, Skv) ||
        reinterpret_cast<uintptr_t>(ws) % 16)
      return cudaErrorInvalidValue;
    auto kernel = presplit_kernel<D, DV>();
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if constexpr (T::CLUSTER > 1) {  // two blocks of this size must fit side by side, or nothing runs
      int clusters = 0;
      if (int e = tf32_clusters_resident<D, DV>(&clusters)) return e;
      if (clusters < 1) return cudaErrorLaunchOutOfResources;
    }
    const int keys_pad = (Skv + SPLIT_KEYS - 1) / SPLIT_KEYS * SPLIT_KEYS;
    const size_t k_floats = static_cast<size_t>(B) * Hkv * Skv * D;
    const size_t vt_floats = static_cast<size_t>(B) * Hkv * DV * keys_pad;
    float *k_hi = ws, *k_lo = k_hi + k_floats, *vt_hi = k_lo + k_floats, *vt_lo = vt_hi + vt_floats;
    tf32_split_kv_kernel<D, DV><<<dim3(keys_pad / SPLIT_KEYS, B * Hkv), 256, 0, stream>>>(
        static_cast<const float*>(k), static_cast<const float*>(v), k_hi, k_lo, vt_hi, vt_lo, Skv, keys_pad);
    CUtensorMap tk_lo, tv_lo;
    if (int e = encode(&tk, k_hi, B * Hkv, Skv, D, TBK, true)) return e;
    if (int e = encode(&tk_lo, k_lo, B * Hkv, Skv, D, TBK, true)) return e;
    // V^T: boxes of TBK keys by the block's DVL rows, rows of 64 bytes at 16
    // keys (vt_desc)
    constexpr CUtensorMapSwizzle VT_SWIZZLE = TBK == 16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    if (int e = encode(&tv, vt_hi, B * Hkv, DV, keys_pad, T::DVL, true, TBK, VT_SWIZZLE)) return e;
    if (int e = encode(&tv_lo, vt_lo, B * Hkv, DV, keys_pad, T::DVL, true, TBK, VT_SWIZZLE)) return e;
    kernel<<<grid, THREADS, smem, stream>>>(tq, tk, tv, tk_lo, tv_lo, static_cast<float*>(o), Hq, Hkv, Sq, Skv, scale,
                                            causal, window, logit_cap);
  } else {
    if (int err = encode(&tk, k, B * Hkv, Skv, D, TBK, true)) return err;
    if (int err = encode(&tv, v, B * Hkv, Skv, DV, TBK, true)) return err;
    auto kernel = D == MLA_D ? flash_attn_tf32_mla_kernel : flash_attn_tf32_kernel;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem, stream>>>(tq, tk, tv, static_cast<float*>(o), Hq, Hkv, Sq, Skv, scale, causal,
                                            window, logit_cap);
  }
  return cudaGetLastError();
}

}  // namespace hopper

}  // namespace

// The kernel the wrapper chose (flash_attention.py's kernel_kind; its
// constants repeat these).
enum Kind { BF16 = 1, F32_TF32 = 2 };

namespace {

// The block of the kernel that takes (kind, D, DV), as its launch sets it
// up: query rows, keys a tile, ring stages, dynamic shared memory in bytes,
// threads, blocks a cluster, and clusters the card holds at once (0 without
// a cluster).
template <int D, int DV>
int block_shape(int kind, int* out) {
  auto put = [out](int bq, int bk, int stages, size_t smem, int threads, int cluster) {
    const int vals[6] = {bq, bk, stages, static_cast<int>(smem), threads, cluster};
    for (int i = 0; i < 6; ++i) out[i] = vals[i];
    out[6] = 0;
    return static_cast<int>(cudaSuccess);
  };
  namespace hp = hopper;
  if (kind == BF16 && D == hp::MLA_D && DV == hp::MLA_DV)
    return put(hp::BQ, hp::MLA_BK, hp::MLA_STAGES, hp::mla_smem_bytes(), hp::THREADS, 1);
  if (kind == BF16) return put(hp::BQ, hp::BK, hp::stages<D, DV>(), hp::smem_bytes<D, DV>(), hp::THREADS, 1);
  if (kind == F32_TF32) {
    using T = hp::Tf32Tiles<D, DV, hp::tf32_bk<D, DV>()>;
    put(hp::BQ, hp::tf32_bk<D, DV>(), T::STAGES, T::SMEM, hp::THREADS, T::CLUSTER);
    return hp::tf32_clusters_resident<D, DV>(out + 6);
  }
  return cudaErrorInvalidValue;
}

// The launch of the kernel that `kind` names at (D, DV).
template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq, int Skv, int kind,
           int causal, int window, float logit_cap, float* ws, long long ws_floats, cudaStream_t s) {
  if (kind == F32_TF32)
    return hopper::launch_tf32<D, DV>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, logit_cap, ws, ws_floats, s);
  if (kind != BF16) return cudaErrorInvalidValue;
  if constexpr (D == hopper::MLA_D)
    return hopper::launch_mla(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, logit_cap, s);
  else
    return hopper::launch<D, DV>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, logit_cap, s);
}

}  // namespace

// The block of the kernel that `kind` names at (d, dv): out[0] query rows,
// out[1] keys a tile, out[2] stages of the K and V ring, out[3] dynamic
// shared memory in bytes, out[4] threads, out[5] blocks a cluster, out[6]
// clusters the card holds at once (0 for a kernel without a cluster).
// Returns the CUDA error.
extern "C" int repro_flash_attention_config(int kind, int d, int dv, int* out) {
  if (d == 64 && dv == 64) return block_shape<64, 64>(kind, out);
  if (d == 128 && dv == 128) return block_shape<128, 128>(kind, out);
  if (d == 64 && dv == 128) return block_shape<64, 128>(kind, out);
  if (d == 128 && dv == 64) return block_shape<128, 64>(kind, out);
  if (d == 256 && dv == 256) return block_shape<256, 256>(kind, out);
  if (d == hopper::MLA_D && dv == hopper::MLA_DV) return block_shape<hopper::MLA_D, hopper::MLA_DV>(kind, out);
  return cudaErrorInvalidValue;
}

// q (B, Hq, Sq, d), k (B, Hkv, Skv, d), v (B, Hkv, Skv, dv), o (B, Hq, Sq, dv),
// all contiguous, 16-byte aligned and of one type: bf16 for BF16, f32 for
// F32_TF32. ws: ws_floats f32 of scratch, 16-byte aligned: none but for
// F32_TF32 at the pairs whose K and V come split ((128, 128), (64, 128),
// (128, 64), (256, 256)), which split them into at least
// tf32_workspace_floats.
// Returns 0 when the launch was accepted, else a CUDA error or, from the
// tensor maps' encoding, ENCODE_ERROR_BASE plus a CUresult.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int B, int Hq, int Hkv, int Sq, int Skv, int d, int dv,
                                         int kind, int causal, int window, float logit_cap,
                                         void* ws, long long ws_floats, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<float*>(ws);
#define REPRO_FA_LAUNCH(D, DV) \
  launch<D, DV>(q, k, v, o, B, Hq, Hkv, Sq, Skv, kind, causal, window, logit_cap, w, ws_floats, s)
  if (d == 64 && dv == 64) return REPRO_FA_LAUNCH(64, 64);
  if (d == 128 && dv == 128) return REPRO_FA_LAUNCH(128, 128);
  if (d == 64 && dv == 128) return REPRO_FA_LAUNCH(64, 128);
  if (d == 128 && dv == 64) return REPRO_FA_LAUNCH(128, 64);
  if (d == 256 && dv == 256) return REPRO_FA_LAUNCH(256, 256);
  if (d == hopper::MLA_D && dv == hopper::MLA_DV) return REPRO_FA_LAUNCH(hopper::MLA_D, hopper::MLA_DV);
#undef REPRO_FA_LAUNCH
  return cudaErrorInvalidValue;
}
