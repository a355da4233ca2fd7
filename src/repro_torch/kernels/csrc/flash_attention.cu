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
// What the design does about it: every (batch, q-head, 64-row q tile) is one
// thread block that keeps its Q tile in shared memory and streams 64-key K/V
// tiles past it, so K and V are read once per q tile and the (Sq x Skv)
// score matrix never reaches device memory.  Tiles that the causal or window
// mask hides entirely are never loaded, which halves the causal work.  The
// ragged Sq / Skv edges are masked inside the kernel: no padded copies.
//
// Two bodies, chosen by the input dtype:
//  * bf16 (the serving path): both products on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate).  Four warps each own 16
//    query rows; the scores and the online softmax stay in registers, and
//    the probabilities are re-packed in place as the A operand of the PV
//    product (rounded to bf16, as the plain attention path rounds them to
//    v's dtype).  K/V tiles are double-buffered: the next tile's 16-byte
//    cp.async copies are in flight while this tile computes.  Fragments
//    come from shared memory through ldmatrix (.trans for V), from rows
//    padded by 8 elements so that each 8-row matrix hits 32 distinct banks.
//    No wgmma, TMA or warp specialisation yet.
//  * f32: FMAs on the CUDA cores (a 4 x 4 score micro-tile and a 4 x Dv/16
//    output micro-tile per thread), which keeps f32 inputs exact to the f32
//    reference (TF32 would not); it is capped by the f32 FMA rate.
//
// Shared memory at D = Dv = 256: 165 KB (bf16 body), 210 KB (f32 body) --
// above the 48 KB static limit, so each launch raises the dynamic limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
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

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, const Args& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBlockQ - 1) / kBlockQ, a.Hq, a.B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

#define REPRO_FA_CASES(X) X(16) X(32) X(64) X(80) X(96) X(128) X(256)

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success).  `res` may be null.  All tensors contiguous (B, S, H, D); bf16
// needs D and Dv multiples of 16 and 16-byte aligned pointers.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v, const void* res,
                              void* out, int dtype, int B, int Sq, int Skv, int Hq, int Hkv,
                              int D, int Dv, int causal, int window, int q_offset, float scale,
                              float out_scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, res, out, B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, q_offset,
               scale, out_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D % 16 != 0) return cudaErrorInvalidValue;
#define REPRO_FA_MMA(DV_) \
  if (Dv == DV_) return launch(flash_fwd_mma_kernel<DV_>, kMmaThreads, mma_smem_bytes(D, DV_), a, s);
    REPRO_FA_CASES(REPRO_FA_MMA)
#undef REPRO_FA_MMA
  } else if (dtype == 0) {
#define REPRO_FA_FMA(DV_) \
  if (Dv == DV_) return launch(flash_fwd_fma_kernel<DV_>, kFmaThreads, fma_smem_bytes(D, DV_), a, s);
    REPRO_FA_CASES(REPRO_FA_FMA)
#undef REPRO_FA_FMA
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
