// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (entry flash_attention, dispatched from kernels/ops.py) and
// computes the same function: streaming online-softmax attention with f32
// running max / sum / accumulator, contiguous positions (pos_q = q_offset +
// i, pos_k = j), causal and sliding-window masks, GQA/MQA through KV head
// h / (Hq / Hkv), D != Dv, rows without any unmasked key -> 0, and the fused
// epilogue out * out_scale + residual.  Inputs are bf16 or f32 in the JAX
// layout (B, S, H, D), contiguous; the output has q's dtype.
//
// What bounds it on an H100 SXM: the work is 2 * (D + Dv) FLOPs for every
// unmasked (query, key) pair -- 4 * B * Hq * Sq * Skv * D at D == Dv, about
// half of that when causal -- against 989 TFLOP/s dense bf16, and the bytes
// of q, k, v and out (each moved once) against 3.35 TB/s.  At the prefill
// shapes of gemma-2b (S ~ 1000, 8 query heads, D = 256) the FLOPs dominate
// (about 290 FLOP per byte moved), so the roofline is the tensor cores.
//
// Common to every body: a (batch, q-head, 64-row q tile) unit streams
// 64-key K/V tiles past its Q tile, so the (Sq x Skv) scores never reach
// device memory, and whole tiles that the causal or window mask hides are
// never loaded (half the causal work).
//
// Three bodies, chosen by shape and dtype (repro_flash_attention_select):
//
//  * wgmma (bf16, scale > 0; D in {64, 128, 192, 256} with Dv in {64, 128,
//    256}: gemma-2b, deepseek-7b, the zoo's 192/128; and (D, Dv) = (80, 80),
//    h2o-danube-1.8b, and (96, 64), minicpm3-4b's MLA).  One CTA of 160
//    threads per work item: warpgroup 0 (128 threads, 64 query rows)
//    computes, warp 4 loads.  What it does about each limit of the mma.sync
//    body below:
//    1. Tensor cores: S = Q K^T is wgmma m64n64k16 with Q and K read from
//       shared memory through descriptors, and O += P V is wgmma m64nDvk16
//       with P from registers (the S accumulator converted in place to bf16
//       pairs, its layout being the A-register layout) and V read MN-major
//       (the transpose bit) from the tile TMA wrote.  Each K/V byte in
//       shared memory feeds all 64 rows of the warpgroup at once, and Q is
//       never re-read into registers.
//    2. Latency: K and V arrive by TMA (cp.async.bulk.tensor, one thread)
//       into a ring of 2 stages with full/empty mbarriers, so the next
//       tile's loads run under this tile's products and softmax.  Tiles are
//       128-byte swizzled (64 bf16 a box row; a D = 256 row is four boxes)
//       and 1024-byte aligned.  The 4-D tensor maps over (d, head, s, batch)
//       zero-fill rows past each batch's S edge.  The softmax folds
//       scale * log2(e) into one FFMA per score before ex2.approx, and masks
//       only tiles that cross the causal diagonal, the window edge or Skv.
//       Shared memory at D = Dv = 256: Q 32 KB + 2 x (K 32 KB + V 32 KB) =
//       160 KB (+ 1 KB alignment), one CTA per SM; no room for a third stage.
//       At D = Dv = 128 it is 80 KB, and two CTAs per SM hide each other's
//       softmax.  (Overlapping one tile's S product with the previous
//       tile's PV product inside the warpgroup, as FlashAttention-3 does,
//       was slower on an H100 80GB HBM3 at both prefill shapes, and is not
//       kept.)
//    3. Too few CTAs: the grid is a list of work items from the split plan
//       (kernels/flash_attention.py::split_plan).  When there are fewer
//       units than SMs, or the longest unit walks more than twice the mean
//       number of key tiles, each unit longer than ceil(tile-steps / 132) is
//       cut into parts of at most that many tiles.  Parts write f32 partials
//       (unnormalised o, max in log2 units, l) to scratch, and
//       flash_merge_kernel merges them in part order (no atomics: the same
//       bits every run) with the epilogue.  Items run heaviest first.
//    4. Host work: the dynamic shared-memory limit is raised once per kernel
//       and device, not per launch; the wrapper caches the plan on the
//       device per shape, uploaded from pinned memory without a stream sync.
//    Registers: ptxas -v (CUDA 12.9) reports 215 registers at D = Dv = 256
//    and 150 at D = Dv = 128, 0 bytes of spill stores in all 12 (D, Dv)
//    instantiations, under launch bounds of one CTA an SM at Dv = 256 and
//    two below.  No setmaxnreg: shared memory already caps the CTAs an SM,
//    so registers the producer warp gave back would feed no other CTA; it
//    belongs with a pingpong of two consumer warpgroups.
//    5. The key tile is a template parameter: 64 keys everywhere, and 128
//       at Dv <= 128 (S = Q K^T as m64n128k16, 64 f32 registers of S a
//       thread beside O, eight PV k-steps a tile, boxes of 128 rows).  A
//       128-key tile halves the ring's barrier round trips and softmax
//       passes a key, but its ring needs twice the shared memory: D 64 keeps
//       two CTAs an SM, D >= 128 drops to one (wg_smem_bytes, and the
//       launch bound follows it).  Which tile is faster at a shape is the
//       tuner's question (kernels/autotune.py); callers that name no tile
//       get 64.
//    6. Head dims that are not a multiple of 64 (80, 96): the kernel is
//       templated on the real D and Dv and keeps its tiles in whole 64-column
//       boxes, DP = pad_box(D) and DVP = pad_box(Dv), both 128 at D 80 and
//       96.  The tensor maps span the real width, so TMA zero-fills the
//       columns past it (no copy of q, k or v on the host), and the
//       barriers expect whole boxes, as they do for rows past S.  S = Q K^T
//       runs D / 16 k-steps (5 at D 80, 6 at D 96) and never multiplies a
//       zero column.  O += P V at Dv 80 runs as m64n128k16, 1.6x the useful
//       MMA work: an MN-major V in the 128-byte swizzle comes in 64-column
//       atoms, so a 64 + 16 split would need another swizzle for the last 16
//       columns.  O then holds 64 f32 a thread, as at Dv 128, and the
//       epilogue and the split path's partials keep only the Dv real
//       columns.  Shared memory is sized by the padded widths: (80, 80) as
//       (128, 128), (96, 64) as (128, 64).  ptxas -v: 150 and 219
//       registers at (80, 80) with 64- and 128-key tiles, 118 and 157 at
//       (96, 64), no spill stores; flash_merge_kernel<80> 40, no spill.
//    flash_merge_kernel: 32 registers, an 8-byte stack frame, 4 bytes of
//    spill stores.
//  * mma.sync (bf16, the other head dims, e.g. the smoke configs' 16 and 32;
//    and on request at any bf16 shape, to time it against wgmma): mma.sync
//    m16n8k16 with f32 accumulation, four warps of 16 query rows, ldmatrix
//    fragments from padded rows, cp.async double-buffered K/V tiles, one CTA
//    per (q tile, head, batch).  Every warp reads the whole K and V tile, so each K/V
//    fragment feeds only 16 rows; shared memory at D = Dv = 256 is 165 KB.
//    ptxas: 243 registers at Dv = 256, 96 to 168 below, no spills.
//  * f32: FMAs on the CUDA cores (a 4 x 4 score micro-tile and a 4 x Dv/16
//    output micro-tile per thread), which keeps f32 inputs exact to the f32
//    reference (TF32 would not); it is capped by the f32 FMA rate.  210 KB
//    of shared memory at D = Dv = 256; ptxas: 64 to 128 registers, no
//    spills.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;  // the key tile of the mma.sync and FMA bodies, and wgmma's default
constexpr float kNegInf = -0.7f * FLT_MAX;  // finite "minus infinity" of the reference

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* res;  // may be null
  void* out;
  int B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, q_offset;
  float scale, out_scale;
};

__device__ __forceinline__ bool visible(int pq, int pk, int Skv, int causal, int window) {
  return pk < Skv && (!causal || pk <= pq) && (window <= 0 || pq - pk < window);
}

// Key range any row of the q tile [q0, q0 + kBlockQ) can see, the start
// rounded down to a tile: whole tiles outside it are skipped (causal future,
// stale window, past Skv).
__device__ __forceinline__ void key_range(const Args& a, int q0, int* begin, int* end) {
  const int q_last = min(a.Sq, q0 + kBlockQ) - 1;
  int e = a.Skv;
  if (a.causal) e = min(e, a.q_offset + q_last + 1);
  int s = 0;
  if (a.window > 0) s = max(0, a.q_offset + q0 - a.window + 1);
  *begin = (s / kBlockK) * kBlockK;
  *end = e;
}

// ---------------------------------------------------------------------------
// bf16 body: mma.sync m16n8k16, 4 warps x 16 query rows
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;
constexpr int kPad = 8;  // elements of row padding: rows stay 16-byte aligned

// Q tile plus two K/V tile buffers (the next tile loads while this one
// computes)
__host__ __device__ constexpr size_t mma_smem_bytes(int d, int dv) {
  return sizeof(bf16) * (size_t)((kBlockQ + 2 * kBlockK) * (d + kPad) + 2 * kBlockK * (dv + kPad));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8x8 b16 matrices from shared memory; lane l gives the row address
// of matrix l / 8, row l % 8.  Without .trans lane (g, t) receives row g,
// columns 2t and 2t + 1 of each matrix; with .trans, rows 2t and 2t + 1 of
// column g -- exactly the mma fragments.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Start copying rows x width elements from global (row stride `stride`)
// into shared (row stride `ld`) with 16-byte cp.async: every copy of the
// tile is in flight at once and none passes through registers.  Rows >=
// valid are zero-filled directly.  Completion: commit() + wait_pending().
__device__ __forceinline__ void stage(bf16* dst, int ld, const bf16* src, long long stride,
                                      int rows, int valid, int width) {
  const int per_row = width / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kMmaThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 8;
    bf16* d = dst + r * ld + c;
    if (r < valid) {
      const uint32_t saddr = static_cast<uint32_t>(__cvta_generic_to_shared(d));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr),
                   "l"(src + r * stride + c));
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed copy groups of this thread are pending
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int DV>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(Args a) {
  constexpr int NT = DV / 8;  // 8-wide output tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D;
  const int ldk = D + kPad, ldv = DV + kPad;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* const sK0 = sQ + kBlockQ * ldk;  // two K/V buffers, selected by `buf`
  bf16* const sK1 = sK0 + kBlockK * ldk;
  bf16* const sV0 = sK1 + kBlockK * ldk;
  bf16* const sV1 = sV0 + kBlockK * ldv;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int lm = lane / 8, lr = lane % 8;  // ldmatrix: matrix and row of this lane
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const long long q_stride = (long long)a.Hq * D, k_stride = (long long)a.Hkv * D;
  const long long v_stride = (long long)a.Hkv * DV, o_stride = (long long)a.Hq * DV;
  const bf16* qb = static_cast<const bf16*>(a.q) + ((long long)b * a.Sq * a.Hq + h) * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + ((long long)b * a.Skv * a.Hkv + hk) * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + ((long long)b * a.Skv * a.Hkv + hk) * DV;
  const long long o_base = ((long long)b * a.Sq * a.Hq + h) * DV;

  const int row0 = warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const int pq[2] = {a.q_offset + q0 + row0, a.q_offset + q0 + row0 + 8};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  int k_begin, k_end;
  key_range(a, q0, &k_begin, &k_end);
  stage(sQ, ldk, qb + q0 * q_stride, q_stride, kBlockQ, a.Sq - q0, D);
  if (k_begin < k_end) {
    stage(sK0, ldk, kb + k_begin * k_stride, k_stride, kBlockK, a.Skv - k_begin, D);
    stage(sV0, ldv, vb + k_begin * v_stride, v_stride, kBlockK, a.Skv - k_begin, DV);
  }
  commit();
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK, buf ^= 1) {
    const int k1 = k0 + kBlockK;
    if (k1 < k_end) {  // prefetch the next tile into the other buffer
      stage(buf ? sK0 : sK1, ldk, kb + k1 * k_stride, k_stride, kBlockK, a.Skv - k1, D);
      stage(buf ? sV0 : sV1, ldv, vb + k1 * v_stride, v_stride, kBlockK, a.Skv - k1, DV);
      commit();
      wait_pending<1>();  // everything but that prefetch has landed
    } else {
      wait_pending<0>();
    }
    __syncthreads();  // this tile (and Q) is visible to every warp
    const bf16* sK = buf ? sK1 : sK0;
    const bf16* sV = buf ? sV1 : sV0;

    // S = Q K^T: 16 rows x 64 keys per warp, in 8 fragments of 16 x 8
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int kk = 0; kk < D; kk += 16) {
      // A: matrices (rows 0-7 | 8-15) x (dims kk | kk + 8) of this warp's Q
      uint32_t af[4];
      ldmatrix_x4(af, sQ + (warp * 16 + (lm & 1) * 8 + lr) * ldk + kk + (lm >> 1) * 8);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        // B of key tiles j, j + 1: matrices (dims kk | kk + 8) x (tile j | j + 1)
        uint32_t kf[4];
        ldmatrix_x4(kf, sK + ((j + (lm >> 1)) * 8 + lr) * ldk + kk + (lm & 1) * 8);
        mma_bf16(s[j], af, kf);
        mma_bf16(s[j + 1], af, kf + 2);
      }
    }

    // mask + online softmax; a row's 4 fragment owners are lanes 4g..4g+3
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pk = k0 + j * 8 + 2 * t + (e & 1);
        // a true -inf gives p = exp(-inf) = 0 exactly: an all-masked row
        // keeps l == 0 and outputs 0
        s[j][e] = visible(pq[e / 2], pk, a.Skv, a.causal, a.window) ? s[j][e] * a.scale
                                                                     : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);  // finite: m starts at kNegInf
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_r[e / 2]);
        sum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = l_r[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: the score fragments of keys [16 ks, 16 ks + 16) are exactly
    // the A fragment of one k-step
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t pa[4] = {pack(s[2 * ks][0], s[2 * ks][1]), pack(s[2 * ks][2], s[2 * ks][3]),
                              pack(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      // B of output tiles n, n + 1 (transposed): matrices (keys 0-7 | 8-15 of
      // this k-step) x (tile n | n + 1)
      const bf16* vr = sV + (ks * 16 + (lm & 1) * 8 + lr) * ldv + (lm >> 1) * 8;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vr + n * 8);
        mma_bf16(o[n], pa, vf);
        mma_bf16(o[n + 1], pa, vf + 2);
      }
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }
  wait_pending<0>();  // no copy outlives the block (no tile: only Q's)

  const bf16* res = static_cast<const bf16*>(a.res);
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int sq = q0 + row0 + 8 * r;
    if (sq >= a.Sq) continue;
    const float l = l_r[r] == 0.f ? 1.f : l_r[r];  // fully masked row -> 0
    const long long o_row = o_base + sq * o_stride;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      float v0 = o[n][2 * r] / l * a.out_scale;
      float v1 = o[n][2 * r + 1] / l * a.out_scale;
      if (res != nullptr) {
        v0 += __bfloat162float(res[o_row + c]);
        v1 += __bfloat162float(res[o_row + c + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + o_row + c) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// Accumulator operands of the wgmma wrappers, eight at a time
#define WG_F8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, f32) (+)= A (64 x 16) * B (16 x 64): A and B from shared memory
// through descriptors, both K-major; scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) (+)= A (64 x 16) * B (16 x 128): A and B from shared
// memory through descriptors, both K-major; scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24),
        WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) * B (16 x 64) from
// shared memory through a descriptor, MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 pairs in registers) * B (16 x 128) from
// shared memory through a descriptor, MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24),
        WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, f32) += A (64 x 16, bf16 pairs in registers) * B (16 x 256) from
// shared memory through a descriptor, MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24),
        WG_F8(32), WG_F8(40), WG_F8(48), WG_F8(56),
        WG_F8(64), WG_F8(72), WG_F8(80), WG_F8(88),
        WG_F8(96), WG_F8(104), WG_F8(112), WG_F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// bf16 body for D in {64, 128, 192, 256}, Dv in {64, 128, 256}: wgmma on
// TMA-fed tiles, one consumer warpgroup, a producer warp, split-KV work items
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 160;  // warpgroup 0 computes, warp 4 loads
constexpr int kStages = 2;       // K/V ring depth
constexpr int kBox = 64;         // elements of one 128-byte swizzled TMA box row
constexpr uint32_t kRowBytes = 128;  // a box row; a box of r rows is r * 128 bytes
// A head dim rounded up to whole 64-column boxes: the wgmma body's width in
// shared memory and, for V, of its PV product (D 80 -> 128, D 96 -> 128)
__host__ __device__ constexpr int pad_box(int w) { return (w + kBox - 1) / kBox * kBox; }
// Shared memory an SM offers its CTAs (228 KB), and what the runtime keeps
// back of it for each CTA (1 KB)
constexpr size_t kSmemPerSm = 228 * 1024, kSmemPerCta = 1024;
constexpr float kLog2e = 1.4426950408889634f;

// One CTA's work: q tile `qt` of (batch b, q-head h) against key tiles
// [kt0, kt1); slot >= 0 sends the unnormalised result to that partial
// instead of the output.  Eight ints: the plan's rows (kernels/flash_attention.py).
struct Item {
  int b, h, qt, kt0, kt1, slot, pad0, pad1;
};
// A split unit, merged from partials slot0 .. slot0 + n_parts - 1 in order
struct Merge {
  int b, h, qt, slot0, n_parts, pad0, pad1, pad2;
};

struct WgArgs {
  Args a;
  const Item* items;
  const Merge* merges;
  float* part_o;   // (slots, kBlockQ, Dv): sum_k p v, unnormalised
  float* part_ml;  // (slots, 2, kBlockQ): running max in log2 units (-inf: no key), sum l
};

// Q, then kStages K tiles, then kStages V tiles of bk keys, each 1024-byte
// aligned for the 128-byte swizzle and as wide as whole boxes (pad_box);
// then 7 mbarriers; plus slack to align the base
__host__ __device__ constexpr size_t wg_smem_bytes(int d, int dv, int bk) {
  return 1024 +
         sizeof(bf16) * (size_t)(kBlockQ * pad_box(d) + kStages * bk * (pad_box(d) + pad_box(dv))) +
         64;
}

// CTAs an SM: the register budget's (Dv = 256: O alone is 128 f32 a thread,
// one CTA; two below, where Dv 80's O is 128 wide), or fewer where shared
// memory holds fewer.  The launch bound is this count, so ptxas budgets
// registers for the CTAs that fit.
__host__ __device__ constexpr int wg_ctas_per_sm(int d, int dv, int bk) {
  const int regs = dv == 256 ? 1 : 2;
  const int fit = (int)(kSmemPerSm / (wg_smem_bytes(d, dv, bk) + kSmemPerCta));
  return fit < regs ? fit : regs;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of this parity has completed.  A wait of
// more than about 2 s traps: a lost transfer fails the launch, it does not
// hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (4LL << 30)) __trap();
  }
}

// TMA: one box of a 4-D tensor map at coordinates (c0, c1, c2, c3),
// innermost first, into shared memory; completes `bytes` on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled shared-memory operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = SW128
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers in place around an asynchronous wgmma: the compiler may not
// move their reads or writes across this point
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void pin(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}


// O (64 x DV) += P (64 x 16, registers) * V (16 x DV, shared memory)
template <int DV>
__device__ __forceinline__ void wgmma_pv(float (&o)[DV / 2], const uint32_t (&p)[4],
                                         uint64_t dv) {
  if constexpr (DV == 64) wgmma_rs_n64(o, p, dv);
  if constexpr (DV == 128) wgmma_rs_n128(o, p, dv);
  if constexpr (DV == 256) wgmma_rs_n256(o, p, dv);
}

// S (64 x BK, f32) (+)= Q (64 x 16) * K^T (16 x BK), both from shared memory
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&s)[BK / 2], uint64_t dq, uint64_t dk,
                                         int scale_d) {
  if constexpr (BK == 64) wgmma_ss_n64(s, dq, dk, scale_d);
  if constexpr (BK == 128) wgmma_ss_n128(s, dq, dk, scale_d);
}

// Grid: one CTA per work item, heaviest first.  Tensor maps are 4-D over
// (d, head, s, batch) with a (64, 1, 64, 1) box for Q and (64, 1, BK, 1) for
// K and V, so rows past a batch's S edge arrive as zeros, and so do the
// columns past D (Dv) of a head dim that is not a multiple of 64: the tiles
// are DP (DVP) columns wide, and every box counts whole in the barriers'
// transaction bytes.  S = Q K^T runs D / 16 k-steps, never a zero column;
// O += P V runs at DVP (Dv 80 as n128: an MN-major operand in the 128-byte
// swizzle comes in 64-column atoms), and only the Dv real columns are kept.
template <int D, int DV, int BK>
__global__ void __launch_bounds__(kWgThreads, wg_ctas_per_sm(D, DV, BK))
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const WgArgs w) {
  constexpr int DP = pad_box(D), DVP = pad_box(DV);
  static_assert(D % 16 == 0 && DV % 16 == 0 && DP <= 256, "head dims: multiples of 16");
  static_assert(DVP == 64 || DVP == 128 || DVP == 256, "PV widths: n64, n128, n256");
  constexpr uint32_t kQBytes = kBlockQ * DP * 2, kKBytes = BK * DP * 2;
  constexpr uint32_t kVBytes = BK * DVP * 2;
  // one 64-column box: 64 rows of Q, BK rows of K or V
  constexpr uint32_t kQBox = kBlockQ * kRowBytes, kKBox = BK * kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + kQBytes;               // stage s at sK + s * kKBytes
  const uint32_t sV = sK + kStages * kKBytes;     // stage s at sV + s * kVBytes
  const uint32_t q_full = sV + kStages * kVBytes;  // then k_full[2], v_full[2], empty[2]
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;
  const Args& a = w.a;
  const Item it = w.items[blockIdx.x];
  const int n_tiles = it.kt1 - it.kt0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer: one thread keeps the ring full; no path rejoins the consumers
    if (lane == 0) {
      const int hk = it.h / (a.Hq / a.Hkv);
      mbar_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int c = 0; c < DP / kBox; ++c)
        tma_load(sQ + c * kQBox, &tm_q, q_full, c * kBox, it.h, it.qt * kBlockQ, it.b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);  // round 0 passes at once
        const int k0 = (it.kt0 + i) * BK;
        mbar_expect_tx(k_full + 8 * s, kKBytes);
#pragma unroll
        for (int c = 0; c < DP / kBox; ++c)
          tma_load(sK + s * kKBytes + c * kKBox, &tm_k, k_full + 8 * s, c * kBox, hk, k0, it.b);
        mbar_expect_tx(v_full + 8 * s, kVBytes);
#pragma unroll
        for (int c = 0; c < DVP / kBox; ++c)
          tma_load(sV + s * kVBytes + c * kKBox, &tm_v, v_full + 8 * s, c * kBox, hk, k0, it.b);
      }
    }
  } else {
    const int g = lane / 4, t = lane % 4;
    const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
    const int q0 = it.qt * kBlockQ, pq0 = a.q_offset + q0;
    const float sl2 = a.scale * kLog2e;  // scores to log2 units: one FFMA with the max
    float o[DVP / 2];  // columns past Dv stay 0: P times V's zero-filled columns
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) o[i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf};  // running max, raw score units
    float l_r[2] = {0.f, 0.f};          // this thread's share of the running sum

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = (it.kt0 + i) * BK;

      // S = Q K^T: Q and K both K-major; a 16-wide k-step is 32 bytes into
      // a swizzled 128-byte row, and every 64 dims the next box
      float sc[BK / 2];
      mbar_wait(k_full + 8 * s, parity);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_qk<BK>(sc, sw128_desc(sQ + (kk / 4) * kQBox + col, 16, 1024),
                     sw128_desc(sK + s * kKBytes + (kk / 4) * kKBox + col, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(sc);

      // sc[4j + e]: row r0 + 8 (e / 2), key k0 + 8 j + 2 t + e % 2.  Only a
      // tile that crosses the causal diagonal, the window edge or Skv masks;
      // a masked score is a true -inf, so an all-masked row keeps l == 0.
      const bool edge = (a.causal && k0 + BK - 1 > pq0) ||
                        (a.window > 0 && pq0 + kBlockQ - 1 - k0 >= a.window) ||
                        k0 + BK > a.Skv;
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!visible(pq0 + r0 + 8 * (e / 2), k0 + 8 * j + 2 * t + (e & 1), a.Skv, a.causal,
                         a.window))
              sc[4 * j + e] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
      float alpha[2], ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);  // finite: m starts at kNegInf
        alpha[r] = ex2((m_r[r] - m_new) * sl2);
        l_r[r] *= alpha[r];
        m_r[r] = m_new;
        ms[r] = m_new == kNegInf ? 0.f : m_new * sl2;  // nothing seen yet: every p is 0
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], sl2, -ms[e / 2]));
          l_r[e / 2] += sc[4 * j + e];  // reduced over the row's 4 lanes at the end
        }
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {  // the zero columns need no rescale
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      // P in place as the A operand, rounded to bf16: the accumulator pairs
      // of keys [16 ks, 16 ks + 16) are exactly one k-step's A registers
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
        for (int x = 0; x < 4; ++x) pa[ks][x] = pack(sc[8 * ks + 2 * x], sc[8 * ks + 2 * x + 1]);

      // O += P V: V is MN-major (Dv contiguous); a 16-key k-step is two
      // 8-row groups (stride 1024 bytes), each 64 columns the next box
      mbar_wait(v_full + 8 * s, parity);
      pin(o);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_pv<DVP>(o, pa[ks], sw128_desc(sV + s * kVBytes + ks * 2048, kKBox, 1024));
      wg_commit();
      wg_wait_all();
      pin(o);
      pin(pa);  // the A registers stay live until the products that read them are done
      mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    if (it.slot < 0) {
      // restrict: the residual loads may all issue before the first store
      const bf16* __restrict__ res = static_cast<const bf16*>(a.res);
      bf16* __restrict__ out = static_cast<bf16*>(a.out);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int sq = q0 + r0 + 8 * r;
        if (sq >= a.Sq) continue;
        const float inv = a.out_scale / (l_r[r] == 0.f ? 1.f : l_r[r]);  // no key -> 0
        const long long o_row = (((long long)it.b * a.Sq + sq) * a.Hq + it.h) * DV;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          const int c = 8 * j + 2 * t;
          float v0 = o[4 * j + 2 * r] * inv, v1 = o[4 * j + 2 * r + 1] * inv;
          if (res != nullptr) {
            const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(res + o_row + c);
            v0 += __low2float(rv);
            v1 += __high2float(rv);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + o_row + c) = __floats2bfloat162_rn(v0, v1);
        }
      }
    } else {
      float* po = w.part_o + (size_t)it.slot * kBlockQ * DV;
      float* pml = w.part_ml + (size_t)it.slot * 2 * kBlockQ;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          *reinterpret_cast<float2*>(po + row * DV + 8 * j + 2 * t) =
              make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
        if (t == 0) {
          pml[row] = m_r[r] == kNegInf ? -INFINITY : m_r[r] * sl2;
          pml[kBlockQ + row] = l_r[r];
        }
      }
    }
  }
}

// Merge the parts of each split unit in part order (no atomics: the same
// bits every run), then the epilogue: out = o / l * out_scale + residual,
// a row that no part saw (l == 0) -> 0.  One CTA per kMergeRows rows of a
// split unit; a thread takes 4 columns of a row, its parts' loads
// independent of each other.
constexpr int kMergeRows = 8;

template <int DV>
__global__ void __launch_bounds__(256) flash_merge_kernel(const WgArgs w) {
  constexpr int kChunks = DV / 4;
  const Args& a = w.a;
  const Merge mg = w.merges[blockIdx.x / (kBlockQ / kMergeRows)];
  const int row0 = (blockIdx.x % (kBlockQ / kMergeRows)) * kMergeRows;
  const float* ml = w.part_ml + (size_t)mg.slot0 * 2 * kBlockQ;
  const bf16* __restrict__ res = static_cast<const bf16*>(a.res);
  bf16* __restrict__ out = static_cast<bf16*>(a.out);
  for (int idx = threadIdx.x; idx < kMergeRows * kChunks; idx += blockDim.x) {
    const int row = row0 + idx / kChunks, c = 4 * (idx % kChunks);
    const int sq = mg.qt * kBlockQ + row;
    if (sq >= a.Sq) continue;
    float mmax = -INFINITY;
    for (int p = 0; p < mg.n_parts; ++p) mmax = fmaxf(mmax, ml[p * 2 * kBlockQ + row]);
    float l = 0.f, v[4] = {0.f, 0.f, 0.f, 0.f};
    if (mmax != -INFINITY) {
#pragma unroll 4
      for (int p = 0; p < mg.n_parts; ++p) {
        const float wt = ex2(ml[p * 2 * kBlockQ + row] - mmax);
        const float4 po = *reinterpret_cast<const float4*>(
            w.part_o + ((size_t)(mg.slot0 + p) * kBlockQ + row) * DV + c);
        l += ml[p * 2 * kBlockQ + kBlockQ + row] * wt;
        v[0] += po.x * wt;
        v[1] += po.y * wt;
        v[2] += po.z * wt;
        v[3] += po.w * wt;
      }
    }
    const float inv = a.out_scale / (l == 0.f ? 1.f : l);
    const long long o_row = (((long long)mg.b * a.Sq + sq) * a.Hq + mg.h) * DV;
    __nv_bfloat162 pair[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float v0 = v[2 * x] * inv, v1 = v[2 * x + 1] * inv;
      if (res != nullptr) {
        const __nv_bfloat162 rv =
            *reinterpret_cast<const __nv_bfloat162*>(res + o_row + c + 2 * x);
        v0 += __low2float(rv);
        v1 += __high2float(rv);
      }
      pair[x] = __floats2bfloat162_rn(v0, v1);
    }
    *reinterpret_cast<uint2*>(out + o_row + c) = *reinterpret_cast<const uint2*>(pair);
  }
}

// ---------------------------------------------------------------------------
// f32 body: CUDA-core FMAs, 16 x 16 threads
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;
constexpr int kLdP = kBlockK + 1;  // padded probability-tile row

// Rows of (d | 1) floats: an odd word stride, so the 16 rows a warp reads at
// one column fall in 16 different banks.
__host__ __device__ constexpr size_t fma_smem_bytes(int d, int dv) {
  return sizeof(float) * (size_t)((kBlockQ + kBlockK) * (d | 1) + kBlockK * (dv | 1) +
                                  kBlockQ * kLdP + 3 * kBlockQ);
}

template <int DV>
__global__ void __launch_bounds__(kFmaThreads) flash_fwd_fma_kernel(Args a) {
  constexpr int NC = DV / 16;  // output columns owned by one thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D;
  const int ldk = D | 1, ldv = DV | 1;
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kBlockQ * ldk;
  float* sV = sK + kBlockK * ldk;
  float* sP = sV + kBlockK * ldv;
  float* sM = sP + kBlockQ * kLdP;  // running row max
  float* sL = sM + kBlockQ;         // running row sum
  float* sA = sL + kBlockQ;         // per-tile rescale exp(m_prev - m_new)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const long long q_stride = (long long)a.Hq * D, k_stride = (long long)a.Hkv * D;
  const long long v_stride = (long long)a.Hkv * DV, o_stride = (long long)a.Hq * DV;
  const float* qb = static_cast<const float*>(a.q) + ((long long)b * a.Sq * a.Hq + h) * D;
  const float* kb = static_cast<const float*>(a.k) + ((long long)b * a.Skv * a.Hkv + hk) * D;
  const float* vb = static_cast<const float*>(a.v) + ((long long)b * a.Skv * a.Hkv + hk) * DV;
  const long long o_base = ((long long)b * a.Sq * a.Hq + h) * DV;

  for (int i = tid; i < kBlockQ * D; i += kFmaThreads) {
    const int r = i / D, c = i - r * D;
    sQ[r * ldk + c] = q0 + r < a.Sq ? qb[(q0 + r) * q_stride + c] : 0.f;
  }
  if (tid < kBlockQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  int k_begin, k_end;
  key_range(a, q0, &k_begin, &k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done with sK/sV/sP
    for (int i = tid; i < kBlockK * D; i += kFmaThreads) {
      const int r = i / D, c = i - r * D;
      sK[r * ldk + c] = k0 + r < a.Skv ? kb[(k0 + r) * k_stride + c] : 0.f;
    }
    for (int i = tid; i < kBlockK * DV; i += kFmaThreads) {
      const int r = i / DV, c = i % DV;
      sV[r * ldv + c] = k0 + r < a.Skv ? vb[(k0 + r) * v_stride + c] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * ldk + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = visible(a.q_offset + q0 + r, k0 + c, a.Skv, a.causal, a.window);
        sP[r * kLdP + c] = ok ? s[i][j] * a.scale : -INFINITY;  // exp(-inf) = 0
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes share one row
    {
      const int r = tid / 4, part = tid % 4;
      float* row = sP + r * kLdP;
      float mx = -INFINITY;
      for (int c = part; c < kBlockK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);  // finite: m starts at kNegInf
      float sum = 0.f;
      for (int c = part; c < kBlockK; c += 4) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
    }
    __syncthreads();

    // O = O * alpha + P V for rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= al;
    }
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kLdP + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = sV[kk * ldv + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // sL is final (also when no tile was visited)

  const float* res = static_cast<const float*>(a.res);
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int sq = q0 + r;
    if (sq >= a.Sq) continue;
    const float l = sL[r] == 0.f ? 1.f : sL[r];  // fully masked row: acc is 0
    const long long o_row = o_base + sq * o_stride;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      float v = acc[i][j] / l * a.out_scale;
      if (res != nullptr) v += res[o_row + c];
      out[o_row + c] = v;
    }
  }
}


// Raise a kernel's dynamic shared-memory limit once per device, not on every
// launch
template <auto Kernel>
cudaError_t raise_smem_limit(size_t smem) {
  static size_t set_bytes[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem <= set_bytes[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) set_bytes[dev] = smem;
  return err;
}

template <auto Kernel>
cudaError_t launch(int threads, size_t smem, const Args& a, cudaStream_t stream) {
  const cudaError_t err = raise_smem_limit<Kernel>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBlockQ - 1) / kBlockQ, a.Hq, a.B);
  Kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver through the runtime: no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A failed encode returns kEncodeError + the CUresult (the wrapper says so)
constexpr int kEncodeError = 100000;

// 4-D map over (d, head, s, batch) of a contiguous (B, S, H, d) bf16 tensor;
// box (64, 1, rows, 1) in the 128-byte swizzle; out-of-range rows read 0
int encode(CUtensorMap* map, const void* ptr, int B, int S, int H, int d, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * d, 2ull * d * H, 2ull * d * H * S};  // bytes, dims 1-3
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int D, int DV, int BK>
int launch_wgmma(const WgArgs& w, int n_items, int n_merges, cudaStream_t stream) {
  const Args& a = w.a;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, a.q, a.B, a.Sq, a.Hq, D, kBlockQ);
  if (err == 0) err = encode(&tk, a.k, a.B, a.Skv, a.Hkv, D, BK);
  if (err == 0) err = encode(&tv, a.v, a.B, a.Skv, a.Hkv, DV, BK);
  if (err != 0) return err;
  const size_t smem = wg_smem_bytes(D, DV, BK);
  err = raise_smem_limit<flash_fwd_wgmma_kernel<D, DV, BK>>(smem);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma_kernel<D, DV, BK><<<n_items, kWgThreads, smem, stream>>>(tq, tk, tv, w);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_merges == 0) return err;
  flash_merge_kernel<DV><<<n_merges * (kBlockQ / kMergeRows), 256, 0, stream>>>(w);
  return cudaGetLastError();
}

#define REPRO_FA_CASES(X) X(16) X(32) X(64) X(80) X(96) X(128) X(256)
// (D, Dv, key tile): 64 keys at every (D, Dv), 128 at Dv <= 128 (at Dv 256
// the 128-key ring would need 296,000 bytes at D 256, past a block's limit)
#define REPRO_FA_WG_DV(X, D_) \
  X(D_, 64, 64) X(D_, 128, 64) X(D_, 256, 64) X(D_, 64, 128) X(D_, 128, 128)
// and the two pairs served at head dims that are not multiples of 64:
// h2o-danube-1.8b's (80, 80) and minicpm3-4b's MLA (96 = nope 64 + rope 32, 64)
#define REPRO_FA_WG_CASES(X)                                                                     \
  REPRO_FA_WG_DV(X, 64) REPRO_FA_WG_DV(X, 128) REPRO_FA_WG_DV(X, 192) REPRO_FA_WG_DV(X, 256)     \
  X(80, 80, 64) X(80, 80, 128) X(96, 64, 64) X(96, 64, 128)

// Whether the wgmma body is built for (D, Dv): every pair has the 64-key tile
bool wg_built(int D, int Dv) {
#define REPRO_FA_WG(D_, DV_, BK_) \
  if (D == D_ && Dv == DV_ && BK_ == kBlockK) return true;
  REPRO_FA_WG_CASES(REPRO_FA_WG)
#undef REPRO_FA_WG
  return false;
}

}  // namespace

extern "C" {

// The body that runs: 0 = f32 FMA, 1 = bf16 mma.sync, 2 = bf16 wgmma; -1 if
// the request cannot run.  request: 0 = by shape and dtype, 1 = mma.sync,
// 2 = wgmma.  By shape and dtype, bf16 at a (D, Dv) the wgmma body is built
// for (D in {64, 128, 192, 256} with Dv in {64, 128, 256}; (80, 80); (96,
// 64)) and scale > 0 (the running max is taken on raw scores) takes wgmma;
// other bf16 head dims take mma.sync.
int repro_flash_attention_select(int dtype, int D, int Dv, float scale, int request) {
  const bool wgmma = dtype == 1 && scale > 0.f && wg_built(D, Dv);
  if (dtype == 0) return request == 0 ? 0 : -1;
  if (dtype != 1 || D % 16 != 0) return -1;
  if (request == 1) return 1;
  if (request == 2) return wgmma ? 2 : -1;
  return request == 0 ? (wgmma ? 2 : 1) : -1;
}

// Dynamic shared memory of one CTA of the bf16 body that (D, Dv) selects
// (scale > 0) with a key tile of block_k: the wgmma body's at an
// instantiated (D, Dv, block_k), the mma.sync body's at block_k 64; -1 for
// a tile that body lacks.  The tuner's fit model (kernels/autotune.py)
// must give the same bytes.
int repro_flash_attention_smem(int D, int Dv, int block_k) {
  switch (repro_flash_attention_select(1, D, Dv, 1.f, 0)) {
    case 2:
#define REPRO_FA_WG(D_, DV_, BK_) \
  if (D == D_ && Dv == DV_ && block_k == BK_) return (int)wg_smem_bytes(D_, DV_, BK_);
      REPRO_FA_WG_CASES(REPRO_FA_WG)
#undef REPRO_FA_WG
      return -1;
    case 1:
      return block_k == kBlockK ? (int)mma_smem_bytes(D, Dv) : -1;
    default:
      return -1;
  }
}

// CTAs of the wgmma body an SM at (D, Dv, block_k): its launch bound, which
// is the register budget's count capped by the shared memory's; -1 for a
// tile it lacks.
int repro_flash_attention_ctas(int D, int Dv, int block_k) {
#define REPRO_FA_WG(D_, DV_, BK_) \
  if (D == D_ && Dv == DV_ && block_k == BK_) return wg_ctas_per_sm(D_, DV_, BK_);
  REPRO_FA_WG_CASES(REPRO_FA_WG)
#undef REPRO_FA_WG
  return -1;
}

// Launches on `stream` and returns the launch's error (0 on success), or
// 100000 + the CUresult of a failed tensor-map encode.  `res` may be null.
// All tensors contiguous (B, S, H, D); bf16 needs D and Dv multiples of 16
// and 16-byte aligned pointers.  The wgmma body takes the work items of the
// split plan at key tile block_k (`items`, n_items rows of 8 ints), its
// merges (n_merges rows of 8 ints, may be 0) and f32 scratch for the
// partials: part_o (slots, 64, Dv) and part_ml (slots, 2, 64).  A key tile
// the body lacks returns cudaErrorInvalidValue: nothing runs another tile.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v, const void* res,
                              void* out, int dtype, int B, int Sq, int Skv, int Hq, int Hkv,
                              int D, int Dv, int causal, int window, int q_offset, float scale,
                              float out_scale, int body, int block_k, const void* items,
                              int n_items, const void* merges, int n_merges, void* part_o,
                              void* part_ml, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, res, out, B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, q_offset,
               scale, out_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  body = repro_flash_attention_select(dtype, D, Dv, scale, body);
  if (body == 2) {
    if (items == nullptr || n_items <= 0 || (n_merges > 0 && (merges == nullptr ||
                                                              part_o == nullptr ||
                                                              part_ml == nullptr)))
      return cudaErrorInvalidValue;
    const WgArgs w{a, static_cast<const Item*>(items), static_cast<const Merge*>(merges),
                   static_cast<float*>(part_o), static_cast<float*>(part_ml)};
#define REPRO_FA_WG(D_, DV_, BK_)             \
  if (D == D_ && Dv == DV_ && block_k == BK_) \
    return launch_wgmma<D_, DV_, BK_>(w, n_items, n_merges, s);
    REPRO_FA_WG_CASES(REPRO_FA_WG)
#undef REPRO_FA_WG
  } else if (block_k != kBlockK) {
    return cudaErrorInvalidValue;
  } else if (body == 1) {
#define REPRO_FA_MMA(DV_) \
  if (Dv == DV_) return launch<flash_fwd_mma_kernel<DV_>>(kMmaThreads, mma_smem_bytes(D, DV_), a, s);
    REPRO_FA_CASES(REPRO_FA_MMA)
#undef REPRO_FA_MMA
  } else if (body == 0) {
#define REPRO_FA_FMA(DV_) \
  if (Dv == DV_) return launch<flash_fwd_fma_kernel<DV_>>(kFmaThreads, fma_smem_bytes(D, DV_), a, s);
    REPRO_FA_CASES(REPRO_FA_FMA)
#undef REPRO_FA_FMA
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
