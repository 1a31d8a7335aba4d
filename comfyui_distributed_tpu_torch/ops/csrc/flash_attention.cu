// Hand-written Hopper attention kernels (sm_90a; mma.sync bf16 -> fp32).
//
// Replaces the Pallas kernels of comfyui_distributed_tpu/ops/flash_attention.py:
//   cdt_flash_attention      <- _flash_kernel_packed (:197) over [B, N, H*D],
//                               and _flash_kernel (:99) as the same core with
//                               H = 1 over the pre-transposed [B*H, N, D]
//   cdt_fused_qkv_attention  <- _flash_kernel_fused (:227)
//
// What bounds them on an H100. Self-attention at the UNet's shapes (N =
// 1024 or 4096, D = 64) does ~N/2 flops per byte moved, far above the
// card's ~295 flop/byte ridge, so the fused kernel (and the one-head core
// at FLUX's 4173 joint tokens, D = 128) is bound by tensor-core operations. Cross-attention over 77
// text tokens does ~77/2 flops per byte: the core there is bound by bytes
// (reading q, writing out). The fused kernel also re-projects each head's
// K/V once per 128-row q block (the TPU schedule): per SDXL UNet forward at
// 1024^2 it does ~12.7 TFLOP where the function needs ~2.9.
//
// Design. One CTA per (q block of 128 rows, head, batch), 8 warps of 16 q
// rows each. The TPU's sequential K grid axis becomes a loop inside the CTA
// over 64-key tiles staged in shared memory; m/l/acc stay in fp32 registers
// (online softmax as in the Pallas kernel, NEG_INF = -1e30 masking, rows
// with l == 0 write 0). Products use mma.sync m16n8k16 with fp32
// accumulation; the S accumulator fragment is re-packed in registers as the
// A operand of P.V (no shared-memory round trip for P). The fused kernel
// streams x and each head's [D, C] weight slice through shared memory in
// 64-channel chunks (the Pallas design keeps all three [C, H*D] weights
// resident, which does not fit 227 KB); q is projected once per CTA and
// kept in registers, k/v tiles are projected per K tile straight into the
// shared-memory tiles the attention step reads, so q/k/v never reach device
// memory. Projections accumulate in fp32 and are rounded to bf16 before
// Q.K^T, like the Pallas kernel. No cp.async/TMA pipelining and no wgmma:
// loads overlap products only across the CTAs that share an SM, which a
// later version should fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;           // q rows per CTA
constexpr int BK = 64;            // keys per K tile
constexpr int KC = 64;            // channels per projection chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;            // bf16 padding per shared-memory row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b for one 16x8x16 tile (A row-major 16x16, B "col" 16x8).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy a ROWS x COLS bf16 tile from global (row stride `stride`) into shared
// memory (row stride `ld`), 16 bytes per thread per step; rows >= n_rows and
// columns >= n_cols read as zero (n_cols is a multiple of 8).
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long stride, int n_rows,
                                          int n_cols) {
  constexpr int PER_ROW = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows && c < n_cols)
      val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Same copy, stored transposed: dst[c][r] = src[r][c].
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile_t(bf16* dst, int ld, const bf16* src,
                                            long long stride, int n_rows) {
  constexpr int PER_ROW = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * ld + r] = e[j];
  }
}

// A fragments of a warp's 16 rows x D columns from shared memory.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const bf16* s, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p = s + g * ld + kk * 16 + 2 * t;
    f[kk][0] = ld32(p);
    f[kk][1] = ld32(p + 8 * ld);
    f[kk][2] = ld32(p + 8);
    f[kk][3] = ld32(p + 8 * ld + 8);
  }
}

// acc[16 rows x D] += xs[16 rows x KC] . ws[D x KC]^T (one channel chunk).
template <int D>
__device__ __forceinline__ void proj_chunk(float (&acc)[D / 8][4],
                                           const bf16* xs, const bf16* ws,
                                           int lane) {
  constexpr int LD = KC + PAD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    uint32_t a[4];
    const bf16* ap = xs + g * LD + kk * 16 + 2 * t;
    a[0] = ld32(ap);
    a[1] = ld32(ap + 8 * LD);
    a[2] = ld32(ap + 8);
    a[3] = ld32(ap + 8 * LD + 8);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const bf16* bp = ws + (nt * 8 + g) * LD + kk * 16 + 2 * t;
      mma16816(acc[nt], a, ld32(bp), ld32(bp + 8));
    }
  }
}

// One K tile of online-softmax attention for a warp's 16 q rows.
// Ks: [BK][D + PAD] keys; Vt: [D][BK + PAD] values transposed.
template <int D>
__device__ __forceinline__ void attend_tile(const uint32_t (&qf)[D / 16][4],
                                            const bf16* Ks, const bf16* Vt,
                                            int valid, float scale,
                                            float (&m)[2], float (&l)[2],
                                            float (&o)[D / 8][4], int lane) {
  constexpr int KLD = D + PAD, VLD = BK + PAD;
  const int g = lane >> 2, t = lane & 3;
  float s[BK / 8][4];
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const bf16* kp = Ks + (nt * 8 + g) * KLD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma16816(s[nt], qf[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
  }
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = nt * 8 + 2 * t + j < valid;
      s[nt][j] = ok ? s[nt][j] * scale : NEG_INF;
      s[nt][2 + j] = ok ? s[nt][2 + j] * scale : NEG_INF;
      mx0 = fmaxf(mx0, s[nt][j]);
      mx1 = fmaxf(mx1, s[nt][2 + j]);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
  const float c0 = expf(m[0] - mn0), c1 = expf(m[1] - mn1);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    s[nt][0] = expf(s[nt][0] - mn0);
    s[nt][1] = expf(s[nt][1] - mn0);
    s[nt][2] = expf(s[nt][2] - mn1);
    s[nt][3] = expf(s[nt][3] - mn1);
    rs0 += s[nt][0] + s[nt][1];
    rs1 += s[nt][2] + s[nt][3];
  }
  rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
  rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
  rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
  rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
  l[0] = l[0] * c0 + rs0;
  l[1] = l[1] * c1 + rs1;
  m[0] = mn0;
  m[1] = mn1;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    o[nt][0] *= c0;
    o[nt][1] *= c0;
    o[nt][2] *= c1;
    o[nt][3] *= c1;
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const bf16* vp = Vt + (nt * 8 + g) * VLD + kk * 16 + 2 * t;
      mma16816(o[nt], a, ld32(vp), ld32(vp + 8));
    }
  }
}

// Normalise and write a warp's 16 rows (row0 relative to `out`).
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long row_stride,
                                           int row0, int n_rows,
                                           const float (&o)[D / 8][4],
                                           const float (&l)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float l0 = l[0] == 0.f ? 1.f : l[0];
  const float l1 = l[1] == 0.f ? 1.f : l[1];
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int d = nt * 8 + 2 * t;
    if (r0 < n_rows)
      *reinterpret_cast<uint32_t*>(out + r0 * row_stride + d) =
          pack_bf16(o[nt][0] / l0, o[nt][1] / l0);
    if (r1 < n_rows)
      *reinterpret_cast<uint32_t*>(out + r1 * row_stride + d) =
          pack_bf16(o[nt][2] / l1, o[nt][3] / l1);
  }
}

template <int D>
__device__ __forceinline__ void init_state(float (&m)[2], float (&l)[2],
                                           float (&o)[D / 8][4]) {
  m[0] = m[1] = NEG_INF;
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
}

// q/k/v/out rows hold heads side by side: head h of row r of batch b starts
// at ptr + b * batch_stride + r * row_stride + h * D.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_core_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int nq,
                  int nk, long long q_bs, long long q_rs, long long k_bs,
                  long long k_rs, long long v_bs, long long v_rs,
                  long long o_bs, long long o_rs, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][D + PAD]
  bf16* Ks = Qs + BQ * (D + PAD);                 // [BK][D + PAD]
  bf16* Vt = Ks + BK * (D + PAD);                 // [D][BK + PAD]
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ;

  load_tile<BQ, D>(Qs, D + PAD, q + b * q_bs + q0 * q_rs + h * D, q_rs,
                   nq - q0, D);
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_a_frags<D>(qf, Qs + warp * 16 * (D + PAD), D + PAD, lane);

  float m[2], l[2], o[D / 8][4];
  init_state<D>(m, l, o);
  const bf16* kb = k + b * k_bs + h * D;
  const bf16* vb = v + b * v_bs + h * D;
  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();
    load_tile<BK, D>(Ks, D + PAD, kb + k0 * k_rs, k_rs, nk - k0, D);
    load_tile_t<BK, D>(Vt, BK + PAD, vb + k0 * v_rs, v_rs, nk - k0);
    __syncthreads();
    attend_tile<D>(qf, Ks, Vt, min(BK, nk - k0), scale, m, l, o, lane);
  }
  store_rows<D>(out + b * o_bs + q0 * o_rs + h * D, o_rs, warp * 16, nq - q0,
                o, l, lane);
}

// x [B, n, c]; wq/wk/wv [H*D, c] (nn.Linear layout); out [B, n, H*D].
// At D = 64 the kernel is held to 128 registers so that two CTAs share an
// SM and hide each other's chunk loads (146 registers left one CTA per SM
// and ran 1.5x slower on the H100); at D = 128 that cap spills.
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
fused_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                 const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                 bf16* __restrict__ out, int n, int c, int hd, float scale) {
  constexpr int XLD = KC + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][KC + PAD]
  bf16* Wa = Xs + BQ * XLD;                        // [D][KC + PAD]
  bf16* Wb = Wa + D * XLD;                         // [D][KC + PAD]
  bf16* Ks = Wb + D * XLD;                         // [BK][D + PAD]
  bf16* Vt = Ks + BK * (D + PAD);                  // [D][BK + PAD]
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const bf16* xb = x + (long long)b * n * c;
  const long long wrow = (long long)h * D * c;

  // q = x[q rows] . wq[head]^T, fp32 accumulation, rounded to bf16
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int c0 = 0; c0 < c; c0 += KC) {
    __syncthreads();
    load_tile<BQ, KC>(Xs, XLD, xb + (long long)q0 * c + c0, c, n - q0, c - c0);
    load_tile<D, KC>(Wa, XLD, wq + wrow + c0, c, D, c - c0);
    __syncthreads();
    proj_chunk<D>(acc, Xs + warp * 16 * XLD, Wa, lane);
  }
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
    qf[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
    qf[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    qf[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }

  float m[2], l[2], o[D / 8][4];
  init_state<D>(m, l, o);
  const int slab = warp & 3;          // warps 0-3 project k, 4-7 project v
  for (int k0 = 0; k0 < n; k0 += BK) {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    for (int c0 = 0; c0 < c; c0 += KC) {
      __syncthreads();
      load_tile<BK, KC>(Xs, XLD, xb + (long long)k0 * c + c0, c, n - k0, c - c0);
      load_tile<D, KC>(Wa, XLD, wk + wrow + c0, c, D, c - c0);
      load_tile<D, KC>(Wb, XLD, wv + wrow + c0, c, D, c - c0);
      __syncthreads();
      proj_chunk<D>(acc, Xs + slab * 16 * XLD, warp < 4 ? Wa : Wb, lane);
    }
    __syncthreads();
    const int r0 = slab * 16 + g;
    if (warp < 4) {
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const int d = nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(Ks + r0 * (D + PAD) + d) =
            pack_bf16(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<uint32_t*>(Ks + (r0 + 8) * (D + PAD) + d) =
            pack_bf16(acc[nt][2], acc[nt][3]);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const int d = nt * 8 + 2 * t;
        Vt[d * (BK + PAD) + r0] = __float2bfloat16(acc[nt][0]);
        Vt[(d + 1) * (BK + PAD) + r0] = __float2bfloat16(acc[nt][1]);
        Vt[d * (BK + PAD) + r0 + 8] = __float2bfloat16(acc[nt][2]);
        Vt[(d + 1) * (BK + PAD) + r0 + 8] = __float2bfloat16(acc[nt][3]);
      }
    }
    __syncthreads();
    attend_tile<D>(qf, Ks, Vt, min(BK, n - k0), scale, m, l, o, lane);
  }
  store_rows<D>(out + (long long)b * n * hd + (long long)q0 * hd + h * D, hd,
                warp * 16, n - q0, o, l, lane);
}

template <int D>
constexpr size_t core_smem() {
  return sizeof(bf16) * (BQ * (D + PAD) + BK * (D + PAD) + D * (BK + PAD));
}

template <int D>
constexpr size_t fused_smem() {
  return sizeof(bf16) *
         (BQ * (KC + PAD) + 2 * D * (KC + PAD) + BK * (D + PAD) + D * (BK + PAD));
}

template <int D>
cudaError_t launch_core(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                        int batch, int heads, int nq, int nk, long long q_bs,
                        long long q_rs, long long k_bs, long long k_rs,
                        long long v_bs, long long v_rs, long long o_bs,
                        long long o_rs, float scale, cudaStream_t stream) {
  const size_t smem = core_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_core_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((nq + BQ - 1) / BQ, heads, batch);
  flash_core_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, nq, nk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fused(const bf16* x, const bf16* wq, const bf16* wk,
                         const bf16* wv, bf16* out, int batch, int heads,
                         int n, int c, float scale, cudaStream_t stream) {
  const size_t smem = fused_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      fused_qkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((n + BQ - 1) / BQ, heads, batch);
  fused_qkv_kernel<D><<<grid, THREADS, smem, stream>>>(x, wq, wk, wv, out, n,
                                                      c, heads * D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Attention over q [batch, nq, heads*D] and k/v [batch, nk, heads*D] given
// by batch and row strides in elements (head h at offset h*D inside a row).
// Returns a cudaError_t; 0 means the kernel was launched.
int cdt_flash_attention(const void* q, const void* k, const void* v, void* out,
                        int batch, int heads, int nq, int nk, int head_dim,
                        long long q_bs, long long q_rs, long long k_bs,
                        long long k_rs, long long v_bs, long long v_rs,
                        long long o_bs, long long o_rs, float scale,
                        void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_core<64>(qp, kp, vp, op, batch, heads, nq, nk, q_bs, q_rs,
                           k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale, s);
  if (head_dim == 128)
    return launch_core<128>(qp, kp, vp, op, batch, heads, nq, nk, q_bs, q_rs,
                            k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale, s);
  return cudaErrorInvalidValue;
}

// Self-attention of x [batch, n, c] projected in-kernel by wq/wk/wv
// [heads*D, c]; writes out [batch, n, heads*D].
int cdt_fused_qkv_attention(const void* x, const void* wq, const void* wk,
                            const void* wv, void* out, int batch, int heads,
                            int n, int c, int head_dim, float scale,
                            void* stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* qp = static_cast<const bf16*>(wq);
  const bf16* kp = static_cast<const bf16*>(wk);
  const bf16* vp = static_cast<const bf16*>(wv);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_fused<64>(xp, qp, kp, vp, op, batch, heads, n, c, scale, s);
  if (head_dim == 128)
    return launch_fused<128>(xp, qp, kp, vp, op, batch, heads, n, c, scale, s);
  return cudaErrorInvalidValue;
}

const char* cdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
