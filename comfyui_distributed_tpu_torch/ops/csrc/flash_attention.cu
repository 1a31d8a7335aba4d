// Hand-written Hopper kernels for the port's attention (sm_90a: TMA,
// mbarrier, wgmma, setmaxnreg).
//
// Replaces the Pallas kernels of comfyui_distributed_tpu/ops/flash_attention.py:
//   cdt_short_kv_attention <- _flash_kernel_packed (:197) (SDXL's cross-
//                             attention over 77 text tokens) and any
//                             attention over at most 128 keys
//   cdt_flash_attention    <- _flash_kernel (:99): the streamed core, for
//                             more than 128 keys
//   cdt_qkv_projection     <- the in-kernel projection of _flash_kernel_fused
//   + an attention launch     (:227); the wrapper launches the two in turn
// The wrapper picks the attention kernel by key count alone, in either
// layout; both read the same 4-D tensor maps.
//
// What bounds them on an H100. Self-attention at the UNet's shapes (N =
// 1024 or 4096, D = 64) and FLUX's joint attention (4173 tokens, D = 128)
// do ~N/2 flops per byte moved, far above the card's ~295 flop/byte ridge:
// the streamed core is bound by tensor-core operations there. Attention
// over 77 keys does ~77/2 flops per byte and is bound by bytes (reading q,
// writing out, each 10.5 MB at SDXL's level 2); at these sizes (3-6 us of
// bytes) what a kernel loses to its bound is latency: launch, the first
// load, the last store. The projection GEMM (8192 x 1920 x 640 at SDXL's
// level 2) is bound by operations.
//
// Design.
// - The TPU kernel projected each head's K/V again for every q block (it
//   bought a way around XLA's custom-call boundary); that is 4.4x the work
//   the function needs. Here K1 projects once: qkv_projection_kernel writes
//   q, k and v as three [B, N, H*D] bf16 buffers (31.5 MB at SDXL's level
//   2, which L2 largely holds), and the attention kernel reads them with
//   packed strides.
// - All three kernels are warp-specialised: warpgroup 0 is the producer
//   (one thread keeps TMA loads in flight through rings of shared-memory
//   stages with full/empty mbarriers), warpgroups 1 and 2 are consumers of
//   64 rows each that run wgmma with fp32 accumulators in registers. In
//   the attention kernels the producer hands its registers to the
//   consumers with setmaxnreg (24 / 232 of 168 at entry; D = 128 needs ~200
//   a consumer thread: S and O are 64 floats each).
// - Tiles arrive by TMA in 128-byte-swizzled boxes of 64 bf16 columns
//   (one swizzle row); D = 128 rows are two boxes. The wgmma descriptors
//   read the same swizzle, so nothing is re-laid out in shared memory: K
//   and the projection's operands are K-major, V is the MN-major
//   (transposed) B operand of P.V.
// - Both attention kernels: S = Q.K^T with both operands in shared memory,
//   softmax in fp32 registers (scale 1/sqrt(D) on the fp32 logits, log2(e)
//   folded into the exp2 constant, keys at or past nk set to NEG_INF since
//   TMA fills them with zeros, rows with l == 0 written as 0), P rounded to
//   bf16 in registers as the A operand of O += P.V. Addresses come from
//   4-D tensor maps {D, rows, heads, batch} built on the host from batch,
//   head and row strides, so one kernel takes the packed [B, N, H*D] rows
//   (K1's second half, K2) and per-head strided rows (K3).
// - The streamed core: one CTA per (128-row q tile, head, batch), K/V
//   tiles of 128 keys through a ring, online softmax. Each consumer runs
//   S, softmax and P.V in turn: the two consumer warpgroups already
//   overlap one's softmax with the other's products, and issuing tile
//   j+1's S before tile j's P.V (FlashAttention-3's in-warpgroup overlap)
//   measured slower on the H100 at D = 64 and 128 (and spilled at 128).
// - The short-key kernel answers the latency: one persistent CTA an SM
//   walks a run of (batch, head, q tile) items numbered head-major, so a
//   head's K and V are loaded once (two K/V stages: the next head's load
//   overlaps the last tile of this one) and stay resident while up to six
//   Q stages stream in ahead of the consumers. Its key tile is sized to
//   the keys (80 or 128 wide: m64n80k16 for SDXL's 77, so S, the
//   exponentials and P.V skip 51 of 128 columns), and one tile takes a
//   one-pass softmax: row max, exponentials, sum, P.V, normalise. Each
//   consumer stages its 64 normalised rows in shared memory in the store
//   map's swizzle (conflict-free) and writes them with one TMA store per
//   box, which overlaps the next tile; it waits for that store to have
//   read the buffer only before refilling it. TMA clips rows past nq. Two
//   CTAs an SM at D = 64 (no setmaxnreg, 80 registers) spilled and
//   measured no faster.
// - The projection: x [M, C] times each nn.Linear weight [H*D, C] (K-major,
//   the layout wgmma's B operand wants) through a 4-stage ring; each
//   output-column tile picks its weight by blockIdx.z; fp32 accumulation
//   rounded to bf16, as the Pallas kernel's projection epilogue. A version
//   with one producer warp and two CTAs an SM measured no faster.
// - Head widths 40, 80 and 160 (SD 1.5's 8 heads at 320, 640 and 1280
//   channels) are read as whole boxes too: a row of D columns takes
//   ceil(D / 64) boxes in shared memory (64, 128 or 192 columns), and
//   only there. The tensor maps carry the true D as their innermost
//   dimension, so TMA fills the columns past D with zeros (never the next
//   head's) and a TMA store is clipped at D. S = Q.K^T runs over
//   ceil(D / 16) k-steps (the zero columns add nothing); P.V computes the
//   padding columns, which are never stored. The 1/sqrt(D) scale comes
//   from the true D. At D = 160 the streamed core takes 64-key tiles (a
//   192-column Q tile and two 128-key K/V stages would need 240 KB of
//   shared memory; three 64-key stages need 192 KB, and S, P and O stay at
//   32 + 16 + 96 registers a thread), and the short-key kernel keeps one
//   K/V stage and takes at most 80 keys (its 128-key tile does not fit
//   beside two Q stages and the output tile).
// Tensor maps are encoded per call in this library through
// cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint, so the
// library does not link libcuda; each kernel's shared-memory limit is
// raised once per device.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 384;      // warpgroup 0 produces, 1 and 2 consume
constexpr int BOX = 64;           // bf16 columns per TMA box: one swizzle row
constexpr int BOX_BYTES = 128 * BOX * 2;   // a [128 rows][64] box: 16 KB
constexpr int BQ = 128;           // q rows per CTA (64 per consumer)
constexpr int GEMM_BM = 128, GEMM_BN = 128, GEMM_BK = 64, GEMM_STAGES = 4;
constexpr int GEMM_STAGE_BYTES = 2 * BOX_BYTES;   // x box + weight box
constexpr int CONSUMER_WARPS = 8;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// codes beside cudaError_t for failures before a launch
constexpr int ERR_NO_ENCODER = 20001;
constexpr int ERR_TENSOR_MAP = 20002;

// --- device helpers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (layout type 1)
// whose 1024-byte swizzle atoms start at 1024-aligned addresses. Byte
// offsets: `lbo` between 64-column blocks of an MN-major operand (unused for
// K-major), `sbo` between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (the asm above does not name the registers).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// TMA store of one box from shared memory, tracked by the issuing thread's
// bulk async-group (rows outside the tensor are not written).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk stores have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until this thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Make this thread's generic-proxy shared-memory writes visible to TMA.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

#define CDT_F8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define CDT_F32 CDT_F8(0), CDT_F8(8), CDT_F8(16), CDT_F8(24)
#define CDT_F40 CDT_F32, CDT_F8(32)
#define CDT_F64 CDT_F32, CDT_F8(32), CDT_F8(40), CDT_F8(48), CDT_F8(56)
#define CDT_F96 \
  CDT_F64, CDT_F8(64), CDT_F8(72), CDT_F8(80), CDT_F8(88)
#define CDT_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define CDT_REGS40                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"
#define CDT_REGS64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define CDT_REGS96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " CDT_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : CDT_F64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 80] (+)= A[64 x 16] . B[80 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n80_ss(float (&d)[40], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %42, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " CDT_REGS40
      ", %40, %41, p, 1, 1, 0, 0;\n}\n"
      : CDT_F40
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CDT_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : CDT_F32
      : "l"(da), "l"(db), "r"(accumulate));
}

// S tile of N keys: d[64 x N] (+)= A[64 x 16] . B[N x 16]^T.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 80 || N == 128, "key tile");
  if constexpr (N == 64)
    wgmma_m64n64_ss(d, da, db, accumulate);
  else if constexpr (N == 80)
    wgmma_m64n80_ss(d, da, db, accumulate);
  else
    wgmma_m64n128_ss(d, da, db, accumulate);
}

// d[64 x 128] += A[64 x 16] (registers) . B[16 x 128] (MN-major in shared memory).
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " CDT_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : CDT_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] (registers) . B[16 x 64] (MN-major in shared memory).
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CDT_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : CDT_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 192] += A[64 x 16] (registers) . B[16 x 192] (MN-major in shared memory).
__device__ __forceinline__ void wgmma_m64n192_rs(float (&d)[96],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %101, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " CDT_REGS96
      ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : CDT_F96
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// --- attention core ------------------------------------------------------------

constexpr int SMEM_LIMIT = 232448;    // dynamic shared memory a block may use

// A head width D in shared memory: BOXES boxes of 64 columns (DP columns,
// zero past D), and the k16 steps of S = Q.K^T that cover D.
template <int D>
struct Width {
  static_assert(D % 8 == 0 && D >= 8 && D <= 192, "head width");
  static constexpr int BOXES = (D + BOX - 1) / BOX;
  static constexpr int DP = BOXES * BOX;
  static constexpr int KSTEPS = (D + 15) / 16;
};

// Shared memory of the core at head width D: the CTA's Q tile (BOXES
// boxes of [128 rows][64]), then STAGES stages of [K tile | V tile], each
// BOXES boxes of [KW rows][64]. KW is 128 keys, 64 past two boxes.
template <int D>
struct CoreLayout {
  static constexpr int BOXES = Width<D>::BOXES;
  static constexpr int KW = BOXES > 2 ? 64 : 128;
  static constexpr int STAGES = BOXES == 2 ? 2 : 3;
  static constexpr int Q_BYTES = BOXES * BOX_BYTES;
  static constexpr int KV_BOX_BYTES = KW * 128;
  static constexpr int KV_TILE_BYTES = BOXES * KV_BOX_BYTES;
  static constexpr int BARRIERS = 1 + 2 * STAGES;
  static constexpr int BYTES = Q_BYTES + 2 * STAGES * KV_TILE_BYTES +
                               BARRIERS * 8 + 1024;   // + alignment
  static_assert(BYTES <= SMEM_LIMIT, "shared memory");
};

// A 64-row warpgroup's DP/2 accumulator floats: O += P . V over one tile
// of KW keys whose 64-column boxes lie `box_bytes` apart.
template <int DP, int KW>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2],
                                           const uint32_t (&p)[KW / 16][4],
                                           uint32_t v_addr, uint32_t box_bytes) {
  static_assert(DP == 64 || DP == 128 || DP == 192, "padded head width");
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk) {
    // keys 16kk..16kk+15: two 8-row groups of 1024 bytes
    const uint64_t db = sw128_desc(v_addr + kk * 2048, box_bytes, 1024);
    if constexpr (DP == 64)
      wgmma_m64n64_rs(o, p[kk], db);
    else if constexpr (DP == 128)
      wgmma_m64n128_rs(o, p[kk], db);
    else
      wgmma_m64n192_rs(o, p[kk], db);
  }
}

// One CTA per (128-row q block, head, batch). q/k/v rows are read through
// 4-D tensor maps {D, rows, heads, batch}; out rows are written at
// out + b * o_bs + h * o_hs + row * o_rs (elements).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           bf16* __restrict__ out, long long o_bs,
                           long long o_hs, long long o_rs, int nq, int nk,
                           float scale_log2) {
  using L = CoreLayout<D>;
  constexpr int KW = L::KW, DP = Width<D>::DP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_tile = align_1024(smem_raw);
  uint8_t* kv_tiles = q_tile + L::Q_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      kv_tiles + 2 * L::STAGES * L::KV_TILE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::STAGES;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (nk + KW - 1) / KW;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Registers: 168 a thread at entry (384 threads); the producer keeps 24
  // and the consumers take 232 (a pool of at most 128 * 24 + 256 * 232).
  if (threadIdx.x < 128) {
    // producer: Q once, then K/V tiles through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int bx = 0; bx < L::BOXES; ++bx)
        tma_load_4d(q_tile + bx * BOX_BYTES, &q_map, q_full, bx * BOX, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % L::STAGES;
        mbar_wait(&empty[s], ((j / L::STAGES) & 1) ^ 1);
        uint8_t* kt = kv_tiles + 2 * s * L::KV_TILE_BYTES;
        mbar_expect_tx(&full[s], 2 * L::KV_TILE_BYTES);
        for (int bx = 0; bx < L::BOXES; ++bx) {
          tma_load_4d(kt + bx * L::KV_BOX_BYTES, &k_map, &full[s], bx * BOX,
                      j * KW, h, b);
          tma_load_4d(kt + L::KV_TILE_BYTES + bx * L::KV_BOX_BYTES, &v_map,
                      &full[s], bx * BOX, j * KW, h, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x - 128;
    const int cwg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
    const int t = lane % 4;
    // this warpgroup's 64 q rows inside each Q box
    const uint32_t q_addr = smem_addr(q_tile) + cwg * 64 * 128;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float s_acc[KW / 2];
#pragma unroll
    for (int i = 0; i < KW / 2; ++i) s_acc[i] = 0.f;
    // rows g and g + 8 of the warp's 16: running max (of raw logits) and
    // this thread's share of the denominator
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % L::STAGES;
      mbar_wait(&full[s], (j / L::STAGES) & 1);
      const uint32_t k_addr = smem_addr(kv_tiles + 2 * s * L::KV_TILE_BYTES);
      const uint32_t v_addr = k_addr + L::KV_TILE_BYTES;

      // S = Q . K^T over D: 16 columns (32 bytes) per step inside a box
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Width<D>::KSTEPS; ++kk) {
        const uint32_t in_box = (kk % 4) * 32;
        wgmma_ss<KW>(s_acc,
                     sw128_desc(q_addr + (kk / 4) * BOX_BYTES + in_box, 16, 1024),
                     sw128_desc(k_addr + (kk / 4) * L::KV_BOX_BYTES + in_box,
                                16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_acc);

      // s_acc[4c + e]: row g (e < 2) or g + 8, key 8c + 2t + (e & 1)
      const int valid = nk - j * KW;
      if (valid < KW) {
#pragma unroll
        for (int c = 0; c < KW / 8; ++c) {
          const int key = c * 8 + 2 * t;
          if (key >= valid) s_acc[4 * c] = s_acc[4 * c + 2] = NEG_INF;
          if (key + 1 >= valid) s_acc[4 * c + 1] = s_acc[4 * c + 3] = NEG_INF;
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int c = 0; c < KW / 8; ++c) {
        mx0 = fmaxf(mx0, fmaxf(s_acc[4 * c], s_acc[4 * c + 1]));
        mx1 = fmaxf(mx1, fmaxf(s_acc[4 * c + 2], s_acc[4 * c + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      // exp(scale * (s - m)) = exp2(s * scale_log2 - m * scale_log2)
      const float corr0 = ex2((m0 - mx0) * scale_log2);
      const float corr1 = ex2((m1 - mx1) * scale_log2);
      m0 = mx0;
      m1 = mx1;
      const float mb0 = mx0 * scale_log2, mb1 = mx1 * scale_log2;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int c = 0; c < KW / 8; ++c) {
        s_acc[4 * c] = ex2(fmaf(s_acc[4 * c], scale_log2, -mb0));
        s_acc[4 * c + 1] = ex2(fmaf(s_acc[4 * c + 1], scale_log2, -mb0));
        s_acc[4 * c + 2] = ex2(fmaf(s_acc[4 * c + 2], scale_log2, -mb1));
        s_acc[4 * c + 3] = ex2(fmaf(s_acc[4 * c + 3], scale_log2, -mb1));
        rs0 += s_acc[4 * c] + s_acc[4 * c + 1];
        rs1 += s_acc[4 * c + 2] + s_acc[4 * c + 3];
      }
      l0 = l0 * corr0 + rs0;
      l1 = l1 * corr1 + rs1;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        o[4 * c] *= corr0;
        o[4 * c + 1] *= corr0;
        o[4 * c + 2] *= corr1;
        o[4 * c + 3] *= corr1;
      }
      // P in bf16 as wgmma A fragments: keys 16kk..16kk+15 are chunks 2kk, 2kk+1
      uint32_t p[KW / 16][4];
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        p[kk][0] = pack_bf16(s_acc[8 * kk], s_acc[8 * kk + 1]);
        p[kk][1] = pack_bf16(s_acc[8 * kk + 2], s_acc[8 * kk + 3]);
        p[kk][2] = pack_bf16(s_acc[8 * kk + 4], s_acc[8 * kk + 5]);
        p[kk][3] = pack_bf16(s_acc[8 * kk + 6], s_acc[8 * kk + 7]);
      }
      wgmma_fence();
      pv_product<DP, KW>(o, p, v_addr, L::KV_BOX_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;   // fully masked rows -> 0
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    const int r0 = q0 + cwg * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
    bf16* base = out + b * o_bs + h * o_hs;
    // columns past D are padding: never stored
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int d = c * 8 + 2 * t;
      if (r0 < nq)
        *reinterpret_cast<uint32_t*>(base + r0 * o_rs + d) =
            pack_bf16(o[4 * c] * inv0, o[4 * c + 1] * inv0);
      if (r1 < nq)
        *reinterpret_cast<uint32_t*>(base + r1 * o_rs + d) =
            pack_bf16(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
    }
  }
}

// --- short-key attention (nk <= 128) ---------------------------------------------

constexpr int SHORT_MAX_KEYS = 128;
constexpr int OUT_ROWS = 64;          // rows of a consumer's TMA store box

// Shared memory of the short-key kernel at head width D and key tile KW:
// KV_STAGES stages of [K tile | V tile] (BOXES boxes of [KW rows][64]
// each), Q_STAGES stages of the 128-row Q tile, and each consumer's
// [64 rows][BOXES * 64] output tile; two K/V stages where they fit beside
// two Q stages, else one; as many Q stages as fit, at most 6.
template <int D, int KW>
struct ShortLayout {
  static constexpr int BOXES = Width<D>::BOXES;
  static constexpr int KV_BOX_BYTES = KW * 128;
  static constexpr int KV_BYTES = 2 * BOXES * KV_BOX_BYTES;
  static constexpr int Q_BYTES = BOXES * BOX_BYTES;
  static constexpr int OUT_BOX_BYTES = OUT_ROWS * 128;
  static constexpr int OUT_BYTES = 2 * BOXES * OUT_BOX_BYTES;
  static constexpr int KV_STAGES =
      2 * KV_BYTES + OUT_BYTES + 2 * Q_BYTES + 1024 + 128 <= SMEM_LIMIT ? 2 : 1;
  static constexpr int FIXED = KV_STAGES * KV_BYTES + OUT_BYTES + 1024 + 128;
  static constexpr int Q_STAGES =
      (SMEM_LIMIT - FIXED) / Q_BYTES < 6 ? (SMEM_LIMIT - FIXED) / Q_BYTES : 6;
  static constexpr int BARRIERS = 2 * Q_STAGES + 2 * KV_STAGES;
  static constexpr int BYTES = FIXED - 128 + Q_STAGES * Q_BYTES + BARRIERS * 8;
  static_assert(KW % 16 == 0 && KW <= SHORT_MAX_KEYS, "key tile");
  static_assert(Q_STAGES >= 2 && BYTES <= SMEM_LIMIT, "shared memory");
};

// Persistent attention over at most KW keys. Work items are (batch, head,
// 128-row q tile), numbered head-major; CTA c takes items [c * per_cta,
// (c + 1) * per_cta). The producer loads a head's K and V once (into the
// other of two K/V stages when the head changes) and streams the q tiles
// through a ring of Q stages; each consumer computes S over the key tile,
// a one-pass softmax, P.V, and stores its 64 normalised rows through
// shared memory with a TMA store that overlaps the next tile.
template <int D, int KW>
__global__ void __launch_bounds__(THREADS, 1)
    short_kv_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap out_map,
                              int nq, int nk, int heads, int items,
                              int per_cta, float scale_log2) {
  using L = ShortLayout<D, KW>;
  constexpr int DP = Width<D>::DP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* kv_tiles = align_1024(smem_raw);
  uint8_t* q_tiles = kv_tiles + L::KV_STAGES * L::KV_BYTES;
  uint8_t* out_tiles = q_tiles + L::Q_STAGES * L::Q_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(out_tiles + L::OUT_BYTES);
  uint64_t* q_empty = q_full + L::Q_STAGES;
  uint64_t* kv_full = q_empty + L::Q_STAGES;
  uint64_t* kv_empty = kv_full + L::KV_STAGES;

  const int q_blocks = (nq + BQ - 1) / BQ;
  const int first = blockIdx.x * per_cta;
  const int last = min(items, first + per_cta);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::Q_STAGES; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], CONSUMER_WARPS);
    }
    for (int s = 0; s < L::KV_STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Registers as in the streamed core: 168 at entry, 24 for the producer,
  // 232 for the consumers.
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int head = -1, kv = -1;
      for (int w = first, j = 0; w < last; ++w, ++j) {
        const int bh = w / q_blocks, qb = w % q_blocks;
        const int h = bh % heads, b = bh / heads;
        if (bh != head) {
          head = bh;
          ++kv;
          const int s = kv % L::KV_STAGES;
          mbar_wait(&kv_empty[s], ((kv / L::KV_STAGES) & 1) ^ 1);
          uint8_t* kt = kv_tiles + s * L::KV_BYTES;
          mbar_expect_tx(&kv_full[s], L::KV_BYTES);
          for (int bx = 0; bx < L::BOXES; ++bx) {
            tma_load_4d(kt + bx * L::KV_BOX_BYTES, &k_map, &kv_full[s], bx * BOX,
                        0, h, b);
            tma_load_4d(kt + (L::BOXES + bx) * L::KV_BOX_BYTES, &v_map,
                        &kv_full[s], bx * BOX, 0, h, b);
          }
        }
        const int s = j % L::Q_STAGES;
        mbar_wait(&q_empty[s], ((j / L::Q_STAGES) & 1) ^ 1);
        mbar_expect_tx(&q_full[s], L::Q_BYTES);
        for (int bx = 0; bx < L::BOXES; ++bx)
          tma_load_4d(q_tiles + s * L::Q_BYTES + bx * BOX_BYTES, &q_map,
                      &q_full[s], bx * BOX, qb * BQ, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x - 128;
    const int cwg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
    const int t = lane % 4, g = lane / 4;
    const bool leader = ct % 128 == 0;
    uint8_t* my_out = out_tiles + cwg * L::BOXES * L::OUT_BOX_BYTES;
    int head = -1, kv = -1;
    uint32_t k_addr = 0;

    for (int w = first, j = 0; w < last; ++w, ++j) {
      const int bh = w / q_blocks, qb = w % q_blocks;
      if (bh != head) {
        // done with the previous head's K/V: hand its stage back
        if (kv >= 0 && lane == 0) mbar_arrive(&kv_empty[kv % L::KV_STAGES]);
        head = bh;
        ++kv;
        const int s = kv % L::KV_STAGES;
        mbar_wait(&kv_full[s], (kv / L::KV_STAGES) & 1);
        k_addr = smem_addr(kv_tiles + s * L::KV_BYTES);
      }
      const uint32_t v_addr = k_addr + L::BOXES * L::KV_BOX_BYTES;
      const int s = j % L::Q_STAGES;
      mbar_wait(&q_full[s], (j / L::Q_STAGES) & 1);
      const uint32_t q_addr = smem_addr(q_tiles + s * L::Q_BYTES) + cwg * 64 * 128;

      // S = Q . K^T over D: 16 columns (32 bytes) per step inside a box
      float s_acc[KW / 2];
#pragma unroll
      for (int i = 0; i < KW / 2; ++i) s_acc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Width<D>::KSTEPS; ++kk) {
        const uint32_t in_box = (kk % 4) * 32;
        wgmma_ss<KW>(s_acc,
                     sw128_desc(q_addr + (kk / 4) * BOX_BYTES + in_box, 16, 1024),
                     sw128_desc(k_addr + (kk / 4) * L::KV_BOX_BYTES + in_box,
                                16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_acc);
      if (lane == 0) mbar_arrive(&q_empty[s]);   // Q is read: refill its stage

      // s_acc[4c + e]: row g (e < 2) or g + 8, key 8c + 2t + (e & 1)
      if (nk < KW) {
#pragma unroll
        for (int c = 0; c < KW / 8; ++c) {
          const int key = c * 8 + 2 * t;
          if (key >= nk) s_acc[4 * c] = s_acc[4 * c + 2] = NEG_INF;
          if (key + 1 >= nk) s_acc[4 * c + 1] = s_acc[4 * c + 3] = NEG_INF;
        }
      }
      // one key tile: the row max, the exponentials and their sum once
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int c = 0; c < KW / 8; ++c) {
        mx0 = fmaxf(mx0, fmaxf(s_acc[4 * c], s_acc[4 * c + 1]));
        mx1 = fmaxf(mx1, fmaxf(s_acc[4 * c + 2], s_acc[4 * c + 3]));
      }
      const float mb0 = quad_max(mx0) * scale_log2;
      const float mb1 = quad_max(mx1) * scale_log2;
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int c = 0; c < KW / 8; ++c) {
        s_acc[4 * c] = ex2(fmaf(s_acc[4 * c], scale_log2, -mb0));
        s_acc[4 * c + 1] = ex2(fmaf(s_acc[4 * c + 1], scale_log2, -mb0));
        s_acc[4 * c + 2] = ex2(fmaf(s_acc[4 * c + 2], scale_log2, -mb1));
        s_acc[4 * c + 3] = ex2(fmaf(s_acc[4 * c + 3], scale_log2, -mb1));
        l0 += s_acc[4 * c] + s_acc[4 * c + 1];
        l1 += s_acc[4 * c + 2] + s_acc[4 * c + 3];
      }
      uint32_t p[KW / 16][4];
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        p[kk][0] = pack_bf16(s_acc[8 * kk], s_acc[8 * kk + 1]);
        p[kk][1] = pack_bf16(s_acc[8 * kk + 2], s_acc[8 * kk + 3]);
        p[kk][2] = pack_bf16(s_acc[8 * kk + 4], s_acc[8 * kk + 5]);
        p[kk][3] = pack_bf16(s_acc[8 * kk + 6], s_acc[8 * kk + 7]);
      }
      float o[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
      wgmma_fence();
      pv_product<DP, KW>(o, p, v_addr, L::KV_BOX_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);

      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;   // fully masked rows -> 0
      const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
      // The output tile is free once the previous store has read it.
      if (leader) bulk_wait_read();
      named_barrier(1 + cwg, 128);
      // rows r and r + 8 of this warp's 16, in the 128-byte swizzle the
      // store map reads: 16-byte chunk c of row r lies at chunk c ^ (r % 8);
      // columns past D are padding, which the store map clips
      const int r0 = warp * 16 + g;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        uint8_t* box = my_out + (c / 8) * L::OUT_BOX_BYTES;
        const int chunk = ((c % 8) ^ g) * 16 + 4 * t;
        *reinterpret_cast<uint32_t*>(box + r0 * 128 + chunk) =
            pack_bf16(o[4 * c] * inv0, o[4 * c + 1] * inv0);
        *reinterpret_cast<uint32_t*>(box + (r0 + 8) * 128 + chunk) =
            pack_bf16(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
      }
      fence_async_shared();
      named_barrier(1 + cwg, 128);
      const int row0 = qb * BQ + cwg * 64;
      if (leader && row0 < nq) {
        const int h = bh % heads, b = bh / heads;
        for (int bx = 0; bx < L::BOXES; ++bx)
          tma_store_4d(&out_map, my_out + bx * L::OUT_BOX_BYTES, bx * BOX, row0,
                       h, b);
        bulk_commit();
      }
    }
    if (leader) bulk_wait();
  }
}

// --- q/k/v projection ------------------------------------------------------------

// out[z] = x . w_z^T for z = 0, 1, 2 (wq, wk, wv): x [m, c], w_z [hd, c]
// (nn.Linear layout), out [3, m, hd] bf16. One CTA per (128-row block,
// 128-column block, z).
__global__ void __launch_bounds__(THREADS, 1)
    qkv_projection_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap wq_map,
                          const __grid_constant__ CUtensorMap wk_map,
                          const __grid_constant__ CUtensorMap wv_map,
                          bf16* __restrict__ out, int m, int hd, int c) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = align_1024(smem_raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + GEMM_STAGES * GEMM_STAGE_BYTES);
  uint64_t* empty = full + GEMM_STAGES;

  const int m0 = blockIdx.x * GEMM_BM, n0 = blockIdx.y * GEMM_BN;
  const int z = blockIdx.z;
  const int k_tiles = (c + GEMM_BK - 1) / GEMM_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0) {
      const CUtensorMap* w_map = z == 0 ? &wq_map : (z == 1 ? &wk_map : &wv_map);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % GEMM_STAGES;
        mbar_wait(&empty[s], ((kt / GEMM_STAGES) & 1) ^ 1);
        uint8_t* st = stages + s * GEMM_STAGE_BYTES;
        mbar_expect_tx(&full[s], GEMM_STAGE_BYTES);
        tma_load_2d(st, &x_map, &full[s], kt * GEMM_BK, m0);
        tma_load_2d(st + BOX_BYTES, w_map, &full[s], kt * GEMM_BK, n0);
      }
    }
  } else {
    const int ct = threadIdx.x - 128;
    const int cwg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % GEMM_STAGES;
      mbar_wait(&full[s], (kt / GEMM_STAGES) & 1);
      const uint32_t xa = smem_addr(stages + s * GEMM_STAGE_BYTES) + cwg * 64 * 128;
      const uint32_t wa = smem_addr(stages + s * GEMM_STAGE_BYTES + BOX_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GEMM_BK / 16; ++kk)
        wgmma_m64n128_ss(d, sw128_desc(xa + kk * 32, 16, 1024),
                         sw128_desc(wa + kk * 32, 16, 1024), 1);
      wgmma_commit();
      // the previous tile's products are done: hand its stage back
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % GEMM_STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(d);

    bf16* dst = out + static_cast<long long>(z) * m * hd;
    const int r0 = m0 + cwg * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < GEMM_BN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * (lane % 4);
      if (col < hd) {
        if (r0 < m)
          *reinterpret_cast<uint32_t*>(dst + static_cast<long long>(r0) * hd + col) =
              pack_bf16(d[4 * j], d[4 * j + 1]);
        if (r1 < m)
          *reinterpret_cast<uint32_t*>(dst + static_cast<long long>(r1) * hd + col) =
              pack_bf16(d[4 * j + 2], d[4 * j + 3]);
      }
    }
  }
}

// --- host side ----------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 tensor map of `rank` dimensions (dims[0] contiguous; strides in
// elements for dims 1..rank-1), read in 128-byte-swizzled boxes of
// [box_rows][64]; out-of-bounds elements read as zero.
int encode(CUtensorMap* map, const void* ptr, int rank, const long long* dims,
           const long long* strides, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t box[4], elem[4];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    box[i] = i == 0 ? BOX : (i == 1 ? box_rows : 1);
    elem[i] = 1;
    if (i > 0) gstride[i - 1] = static_cast<cuuint64_t>(strides[i - 1]) * sizeof(bf16);
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(ptr), gdim, gstride, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// Raise a kernel's dynamic shared-memory limit once per device; `done`
// is the calling launcher's own static bit set of devices.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<uint32_t>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint32_t bit = 1u << (dev & 31);
  if (done->load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done->fetch_or(bit);
  return e;
}

// The q, k, v tensor maps {D, rows, heads, batch} of an attention launch,
// from (batch, head, row) strides; q in boxes of BQ rows, k/v of kv_rows.
template <int D>
int encode_qkv(CUtensorMap* maps, const void* q, const void* k,
               const void* v, int batch, int heads, int nq, int nk,
               const long long* qs, const long long* ks, const long long* vs,
               int kv_rows) {
  const void* ptrs[3] = {q, k, v};
  const long long* strides[3] = {qs, ks, vs};
  for (int i = 0; i < 3; ++i) {
    // strides arrive as (batch, head, row); the map takes (row, head, batch)
    const long long dims[4] = {D, i == 0 ? nq : nk, heads, batch};
    const long long st[3] = {strides[i][2], strides[i][1], strides[i][0]};
    const int rc = encode(&maps[i], ptrs[i], 4, dims, st, i == 0 ? BQ : kv_rows);
    if (rc) return rc;
  }
  return 0;
}

int sm_count() {
  static std::atomic<int> counts[32];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int n = counts[dev & 31].load(std::memory_order_relaxed);
  if (n == 0 &&
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    counts[dev & 31].store(n, std::memory_order_relaxed);
  return n;
}

template <int D>
int launch_attention(const void* q, const void* k, const void* v, bf16* out,
                     int batch, int heads, int nq, int nk, const long long* qs,
                     const long long* ks, const long long* vs,
                     const long long* os, float scale, cudaStream_t stream) {
  using L = CoreLayout<D>;
  CUtensorMap maps[3];
  const int rc =
      encode_qkv<D>(maps, q, k, v, batch, heads, nq, nk, qs, ks, vs, L::KW);
  if (rc) return rc;
  static std::atomic<uint32_t> smem_set{0};
  const cudaError_t e = allow_smem(flash_attention_kernel<D>, L::BYTES, &smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((nq + BQ - 1) / BQ, heads, batch);
  flash_attention_kernel<D><<<grid, THREADS, L::BYTES, stream>>>(
      maps[0], maps[1], maps[2], out, os[0], os[1], os[2], nq, nk,
      scale * LOG2E);
  return cudaGetLastError();
}

template <int D, int KW>
int launch_short_kv(const void* q, const void* k, const void* v, bf16* out,
                    int batch, int heads, int nq, int nk, const long long* qs,
                    const long long* ks, const long long* vs,
                    const long long* os, float scale, cudaStream_t stream) {
  using L = ShortLayout<D, KW>;
  CUtensorMap maps[4];
  int rc = encode_qkv<D>(maps, q, k, v, batch, heads, nq, nk, qs, ks, vs, KW);
  const long long dims[4] = {D, nq, heads, batch};
  const long long st[3] = {os[2], os[1], os[0]};
  if (rc == 0) rc = encode(&maps[3], out, 4, dims, st, OUT_ROWS);
  if (rc) return rc;
  static std::atomic<uint32_t> smem_set{0};
  const cudaError_t e =
      allow_smem(short_kv_attention_kernel<D, KW>, L::BYTES, &smem_set);
  if (e != cudaSuccess) return e;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  // head-major items; as even a split over the SMs as whole runs allow
  const int items = batch * heads * ((nq + BQ - 1) / BQ);
  if (items <= 0) return cudaErrorInvalidConfiguration;
  const int per_cta = (items + sms - 1) / sms;
  const int grid = (items + per_cta - 1) / per_cta;
  short_kv_attention_kernel<D, KW><<<grid, THREADS, L::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], nq, nk, heads, items, per_cta,
      scale * LOG2E);
  return cudaGetLastError();
}

// The short-key kernel's key tile for nk keys at head width D: 80 (77
// text tokens) or 128; 0 past SHORT_MAX_KEYS, and past 80 keys at D = 160
// (its 128-key tile does not fit).
template <int D>
int key_tile(int nk) {
  const int max_keys = Width<D>::BOXES > 2 ? 80 : SHORT_MAX_KEYS;
  if (nk < 1 || nk > max_keys) return 0;
  return nk <= 80 ? 80 : 128;
}

// Only the short-key kernels that key_tile selects are instantiated.
template <int D, int KW>
constexpr bool has_short_kv() {
  return KW == 80 || Width<D>::BOXES <= 2;
}

template <typename L>
int layout_report(int* q_stages) {
  *q_stages = L::Q_STAGES;
  return L::BYTES;
}

template <int D>
int short_kv_layout(int nk, int* q_stages) {
  switch (key_tile<D>(nk)) {
    case 80:
      return layout_report<ShortLayout<D, 80>>(q_stages);
    case 128:
      if constexpr (has_short_kv<D, 128>())
        return layout_report<ShortLayout<D, 128>>(q_stages);
      return 0;
    default:
      return 0;
  }
}

template <int D>
int launch_short_kv_d(const void* q, const void* k, const void* v, bf16* out,
                      int batch, int heads, int nq, int nk, const long long* qs,
                      const long long* ks, const long long* vs,
                      const long long* os, float scale, cudaStream_t stream) {
  switch (key_tile<D>(nk)) {
    case 80:
      return launch_short_kv<D, 80>(q, k, v, out, batch, heads, nq, nk, qs, ks,
                                    vs, os, scale, stream);
    case 128:
      if constexpr (has_short_kv<D, 128>())
        return launch_short_kv<D, 128>(q, k, v, out, batch, heads, nq, nk, qs,
                                       ks, vs, os, scale, stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Attention over q [batch, nq, heads, D] and k/v [batch, nk, heads, D]
// given by (batch, head, row) strides in elements for each of q, k, v and
// out (unit stride inside a head's D). Returns 0 when the kernel was
// launched, else a cudaError_t or one of the codes above.
int cdt_flash_attention(const void* q, const void* k, const void* v, void* out,
                        int batch, int heads, int nq, int nk, int head_dim,
                        long long q_bs, long long q_hs, long long q_rs,
                        long long k_bs, long long k_hs, long long k_rs,
                        long long v_bs, long long v_hs, long long v_rs,
                        long long o_bs, long long o_hs, long long o_rs,
                        float scale, void* stream) {
  const long long qs[3] = {q_bs, q_hs, q_rs}, ks[3] = {k_bs, k_hs, k_rs};
  const long long vs[3] = {v_bs, v_hs, v_rs}, os[3] = {o_bs, o_hs, o_rs};
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 40:
      return launch_attention<40>(q, k, v, op, batch, heads, nq, nk, qs, ks,
                                  vs, os, scale, s);
    case 64:
      return launch_attention<64>(q, k, v, op, batch, heads, nq, nk, qs, ks,
                                  vs, os, scale, s);
    case 80:
      return launch_attention<80>(q, k, v, op, batch, heads, nq, nk, qs, ks,
                                  vs, os, scale, s);
    case 128:
      return launch_attention<128>(q, k, v, op, batch, heads, nq, nk, qs, ks,
                                   vs, os, scale, s);
    case 160:
      return launch_attention<160>(q, k, v, op, batch, heads, nq, nk, qs, ks,
                                   vs, os, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The same attention and arguments as cdt_flash_attention, for 1 <= nk <=
// 128: the short-key kernel (K/V resident, q tiles streamed, TMA stores).
int cdt_short_kv_attention(const void* q, const void* k, const void* v,
                           void* out, int batch, int heads, int nq, int nk,
                           int head_dim, long long q_bs, long long q_hs,
                           long long q_rs, long long k_bs, long long k_hs,
                           long long k_rs, long long v_bs, long long v_hs,
                           long long v_rs, long long o_bs, long long o_hs,
                           long long o_rs, float scale, void* stream) {
  const long long qs[3] = {q_bs, q_hs, q_rs}, ks[3] = {k_bs, k_hs, k_rs};
  const long long vs[3] = {v_bs, v_hs, v_rs}, os[3] = {o_bs, o_hs, o_rs};
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 40:
      return launch_short_kv_d<40>(q, k, v, op, batch, heads, nq, nk, qs, ks,
                                   vs, os, scale, s);
    case 64:
      return launch_short_kv_d<64>(q, k, v, op, batch, heads, nq, nk, qs, ks,
                                   vs, os, scale, s);
    case 80:
      return launch_short_kv_d<80>(q, k, v, op, batch, heads, nq, nk, qs, ks,
                                   vs, os, scale, s);
    case 128:
      return launch_short_kv_d<128>(q, k, v, op, batch, heads, nq, nk, qs, ks,
                                    vs, os, scale, s);
    case 160:
      return launch_short_kv_d<160>(q, k, v, op, batch, heads, nq, nk, qs, ks,
                                    vs, os, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The short-key kernel that nk keys at head_dim select, for build
// reports: returns its dynamic shared memory in bytes (0 where no kernel
// is selected) and sets its number of Q stages.
int cdt_short_kv_layout(int head_dim, int nk, int* q_stages) {
  *q_stages = 0;
  switch (head_dim) {
    case 40:
      return short_kv_layout<40>(nk, q_stages);
    case 64:
      return short_kv_layout<64>(nk, q_stages);
    case 80:
      return short_kv_layout<80>(nk, q_stages);
    case 128:
      return short_kv_layout<128>(nk, q_stages);
    case 160:
      return short_kv_layout<160>(nk, q_stages);
    default:
      return 0;
  }
}

// out [3, m, hd] = x [m, c] times wq, wk, wv [hd, c] transposed, in bf16
// with fp32 accumulation. x and the weights are contiguous.
int cdt_qkv_projection(const void* x, const void* wq, const void* wk,
                       const void* wv, void* out, int m, int c, int hd,
                       void* stream) {
  CUtensorMap maps[4];
  const long long x_dims[2] = {c, m}, w_dims[2] = {c, hd}, stride[1] = {c};
  int rc = encode(&maps[0], x, 2, x_dims, stride, GEMM_BM);
  const void* ws[3] = {wq, wk, wv};
  for (int i = 0; i < 3 && rc == 0; ++i)
    rc = encode(&maps[1 + i], ws[i], 2, w_dims, stride, GEMM_BN);
  if (rc) return rc;
  const int smem = GEMM_STAGES * GEMM_STAGE_BYTES + 2 * GEMM_STAGES * 8 + 1024;
  static std::atomic<uint32_t> smem_set{0};
  const cudaError_t e = allow_smem(qkv_projection_kernel, smem, &smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((m + GEMM_BM - 1) / GEMM_BM, (hd + GEMM_BN - 1) / GEMM_BN, 3);
  qkv_projection_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<bf16*>(out), m, hd, c);
  return cudaGetLastError();
}

const char* cdt_error_string(int code) {
  if (code == ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (code == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused a tensor map (alignment, strides "
           "or sizes)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
