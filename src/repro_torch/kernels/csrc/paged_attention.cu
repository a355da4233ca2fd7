// Paged decode attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package computes paged attention as an
// XLA gather of every slot's whole block-table row followed by plain
// attention (src/repro/kernels/ops.py::paged_attention), as the port does on
// a CPU tensor (entry paged_attention, dispatched from kernels/ops.py).  It
// computes the same function, one query token a slot:
//
//   out[b, hq] = softmax_j(scale * q[b, hq] . k_j) v_j over the keys j of
//   slot b's pages whose pool position p_j passes the mask: p_j >= 0,
//   p_j <= pos_q[b] when causal, pos_q[b] - p_j < window when window > 0;
//   query head hq reads kv head hq / (Hq / Hkv).
//
// q: (B, Hq, D) bf16 or f32; k, v: (n_pages + 1, page_size, Hkv, D) pools in
// bf16 or f32 (their own dtype, read as is); pos: (n_pages + 1, page_size)
// int32; table: (B, max_pages) int32, entries outside [0, n_pages) are
// unallocated and never read (the pool's last page is the write-only trash
// page); pos_q: (B,) int32.  out: (B, Hq, D) in q's dtype.  A row with
// pos_q < 0 (an inactive slot) reads nothing and writes zeros.
//
// What bounds it on an H100 SXM: bytes.  Each live key costs 2 * D * 2
// bytes a kv head in bf16 (K and V) for 4 * D FLOPs a query head of its
// group, one FLOP a byte or two, under a hundredth of the 295 the tensor
// cores need; so the least time is the live pages' K and V over 3.35 TB/s
// (granite-moe-1b-a400m, 64 slots of ~2,210 live keys, 8 kv heads of 64:
// 290 MB a layer, 87 us), and CUDA-core FMAs in f32 are enough.
//
// What the design does about it:
//  1. Reads only live pages, once: a CTA owns one (slot, kv head, page
//     range) and all the query heads of the kv head's group (GC of them,
//     a template parameter; larger groups are cut into chunks of GC), so
//     each K and V byte is loaded once and used by every head of the group.
//     A range stops at the page that holds pos_q (causal), starts at the
//     window's first page, and reads no key past pos_q or before the window;
//     ranges wholly outside that exit at once.  The engine's allocation-time
//     reset sets every later position of a slot's pages to -1, so the keys
//     left unread are keys the mask would drop.
//  2. Coalesced 16-byte loads in the pool's dtype: a key row of D elements
//     is read by D / 8 neighbouring threads (a lane group), 8 elements each
//     (16 bytes in bf16, two 16-byte loads in f32), widened to f32 in
//     registers.  The 128 threads of a CTA form 128 / (D / 8) lane groups,
//     each walking its own keys; a group loads U keys' K, V and positions
//     before it computes, so several loads a thread are in flight.
//  3. f32 arithmetic throughout: q . k reduced across the lane group with
//     shuffles (every lane ends with the same bits), an online softmax per
//     lane group and query head in log2 units (scale * log2(e) folded into
//     q), f32 accumulation of P V, one rounding to q's dtype at the end.
//     A masked key's V is never multiplied in, so stale values in a
//     recycled page cannot reach the sum.
//  4. Balance over the 132 SMs: 64 slots x 8 kv heads is under four units
//     an SM, and live lengths differ 4x.  The host cuts every (slot, kv
//     head) into the same n_ranges page ranges, chosen from the shapes alone
//     (kernels/paged_attention.py::page_split), so the grid is fixed and a
//     CUDA graph can hold it.  With more than one range, each live range
//     writes f32 partials (unnormalised o, max in log2 units, sum) and
//     paged_attn_merge_kernel merges them in range order; inside a CTA the
//     lane groups merge through shared memory in group order.  No atomics:
//     the same inputs give the same bits, eager or replayed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kEpt = 8;  // elements of a key row a thread owns

struct Args {
  const void* q;       // (B, Hq, D)
  const void* k;       // (n_pages + 1, ps, Hkv, D)
  const void* v;
  const int* pos;      // (n_pages + 1, ps)
  const int* table;    // (B, max_pages)
  const int* pos_q;    // (B,)
  void* out;           // (B, Hq, D)
  float* part_o;       // (B, Hq, n_ranges, D)
  float* part_ml;      // (B, Hq, n_ranges, 2)
  int B, Hq, Hkv, G, D, n_pages, ps, ps_shift, max_pages, range_pages, n_ranges;
  int causal, window, q_bf16;
  float scale_log2;
};

// The slot's pages [first, last] that hold a key the query at pq can see;
// empty (last < first) for an inactive row.
__device__ __forceinline__ void live_pages(const Args& a, int pq, int& first, int& last) {
  if (pq < 0) {
    first = 0;
    last = -1;
    return;
  }
  last = a.causal ? min(pq / a.ps, a.max_pages - 1) : a.max_pages - 1;
  first = a.window > 0 ? max(0, pq - a.window + 1) / a.ps : 0;
}

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// Eight consecutive elements of a row, as loaded: bf16 packed in one uint4,
// f32 in two float4.
template <typename T>
struct Row8;

template <>
struct Row8<__nv_bfloat16> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void widen(float (&x)[kEpt]) const {
    x[0] = bf16_lo(r.x);
    x[1] = bf16_hi(r.x);
    x[2] = bf16_lo(r.y);
    x[3] = bf16_hi(r.y);
    x[4] = bf16_lo(r.z);
    x[5] = bf16_hi(r.z);
    x[6] = bf16_lo(r.w);
    x[7] = bf16_hi(r.w);
  }
};

template <>
struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void widen(float (&x)[kEpt]) const {
    x[0] = a.x;
    x[1] = a.y;
    x[2] = a.z;
    x[3] = a.w;
    x[4] = b.x;
    x[5] = b.y;
    x[6] = b.z;
    x[7] = b.w;
  }
};

__device__ __forceinline__ void load_q(const Args& a, long long off, float scale, float (&x)[kEpt]) {
  if (a.q_bf16) {
    Row8<__nv_bfloat16> r;
    r.load(static_cast<const __nv_bfloat16*>(a.q) + off);
    r.widen(x);
  } else {
    Row8<float> r;
    r.load(static_cast<const float*>(a.q) + off);
    r.widen(x);
  }
#pragma unroll
  for (int e = 0; e < kEpt; ++e) x[e] *= scale;
}

__device__ __forceinline__ void store_out(const Args& a, long long off, float x) {
  if (a.q_bf16)
    static_cast<__nv_bfloat16*>(a.out)[off] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(a.out)[off] = x;
}

// Weight of a part with max m against the overall max M (both log2 units):
// 0 for a part that saw no key.
__device__ __forceinline__ float part_weight(float m, float M) {
  return m == -INFINITY ? 0.f : exp2f(m - M);
}

// One CTA: slot blockIdx.z, kv head and query-head chunk blockIdx.y, page
// range blockIdx.x.  TKV: the pools' element type; D: the head dim; GC: the
// query heads a CTA serves.
template <typename TKV, int D, int GC>
__global__ void __launch_bounds__(kThreads, GC >= 8 ? 2 : 4) paged_attn_kernel(const Args a) {
  constexpr int T = D / kEpt;       // threads of a lane group (one key row)
  constexpr int LG = kThreads / T;  // lane groups of the CTA
  constexpr int U = (sizeof(TKV) == 4 || GC >= 4) ? 2 : 4;  // keys a group loads at once
  static_assert(T >= 1 && T <= 32 && (32 % T) == 0, "D / 8 must divide a warp");
  __shared__ float sm_m[LG][GC];
  __shared__ float sm_l[LG][GC];
  __shared__ float sm_o[LG][GC][D];

  const int range = blockIdx.x;
  const int chunks = a.G / GC;
  const int h = blockIdx.y / chunks;
  const int hq0 = h * a.G + (blockIdx.y % chunks) * GC;
  const int b = blockIdx.z;
  const int grp = threadIdx.x / T, lane = threadIdx.x % T;

  const int pq = a.pos_q[b];
  int first, last;
  live_pages(a, pq, first, last);
  const int p0 = max(first, range * a.range_pages);
  const int p1 = min(last + 1, (range + 1) * a.range_pages);
  const bool single = a.n_ranges == 1;
  if (p0 >= p1 && !single) return;  // the merge reads live ranges only

  float qr[GC][kEpt];
#pragma unroll
  for (int g = 0; g < GC; ++g)
    load_q(a, (static_cast<long long>(b) * a.Hq + hq0 + g) * D + lane * kEpt, a.scale_log2, qr[g]);
  float m[GC], l[GC], acc[GC][kEpt];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kEpt; ++e) acc[g][e] = 0.f;
  }

  // the range's keys as flat indices of the slot's view: position t lives at
  // page t / ps, row t % ps; none past pos_q (causal) or before the window
  int t_begin = p0 * a.ps, t_end = p1 * a.ps;
  if (p0 < p1) {
    if (a.causal) t_end = min(t_end, pq + 1);
    if (a.window > 0) t_begin = max(t_begin, pq - a.window + 1);
  }
  const int* trow = a.table + static_cast<long long>(b) * a.max_pages;
  const TKV* kp = static_cast<const TKV*>(a.k) + static_cast<long long>(h) * D + lane * kEpt;
  const TKV* vp = static_cast<const TKV*>(a.v) + static_cast<long long>(h) * D + lane * kEpt;
  const long long row_stride = static_cast<long long>(a.Hkv) * D;

  for (int t0 = t_begin; t0 < t_end; t0 += LG * U) {
    Row8<TKV> kx[U], vx[U];
    int kpos[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * LG + grp;
      kpos[u] = -1;
      kx[u].zero();
      vx[u].zero();
      if (t < t_end) {
        const int lp = a.ps_shift >= 0 ? t >> a.ps_shift : t / a.ps;
        const int page = __ldg(trow + lp);
        if (page >= 0 && page < a.n_pages) {
          const long long row = static_cast<long long>(page) * a.ps + (t - lp * a.ps);
          kpos[u] = __ldg(a.pos + row);
          kx[u].load(kp + row * row_stride);
          vx[u].load(vp + row * row_stride);
        }
      }
    }
    bool valid[U];
    float s[U][GC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = kpos[u];
      valid[u] = p >= 0 && (!a.causal || p <= pq) && (a.window <= 0 || pq - p < a.window);
      float kf[kEpt];
      kx[u].widen(kf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < kEpt; ++e) d = fmaf(qr[g][e], kf[e], d);
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int off = T / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GC; ++g) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
    }
    float vf[U][kEpt];
#pragma unroll
    for (int u = 0; u < U; ++u) vx[u].widen(vf[u]);
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = valid[u] ? s[u][g] : -INFINITY;
        mx = fmaxf(mx, s[u][g]);
      }
      const float mn = fmaxf(m[g], mx);
      if (mn == -INFINITY) continue;  // nothing seen yet (uniform in the group)
      const float alpha = exp2f(m[g] - mn);
      float p[U], psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = exp2f(s[u][g] - mn);
        psum += p[u];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int e = 0; e < kEpt; ++e) {
        float o = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (valid[u]) o = fmaf(p[u], vf[u][e], o);
        acc[g][e] = o;
      }
      m[g] = mn;
    }
  }

  // merge the lane groups in group order, then normalise (one range) or
  // write the range's partial
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      sm_m[grp][g] = m[g];
      sm_l[grp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < kEpt; ++e) sm_o[grp][g][lane * kEpt + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GC * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
    for (int j = 0; j < LG; ++j) M = fmaxf(M, sm_m[j][g]);
    float L = 0.f, O = 0.f;
    if (M != -INFINITY) {
      for (int j = 0; j < LG; ++j) {
        const float w = part_weight(sm_m[j][g], M);
        L = fmaf(w, sm_l[j][g], L);
        O = fmaf(w, sm_o[j][g][d], O);
      }
    }
    const long long bh = static_cast<long long>(b) * a.Hq + hq0 + g;
    if (single) {
      store_out(a, bh * D + d, L > 0.f ? O / L : 0.f);
    } else {
      const long long part = bh * a.n_ranges + range;
      a.part_o[part * D + d] = O;
      if (d == 0) {
        a.part_ml[2 * part] = M;
        a.part_ml[2 * part + 1] = L;
      }
    }
  }
}

// One CTA a (slot, query head): the live ranges' partials, merged in range
// order; zeros for a row that saw no key.
__global__ void __launch_bounds__(64) paged_attn_merge_kernel(const Args a) {
  const long long bh = blockIdx.x;
  const int b = static_cast<int>(bh / a.Hq);
  int first, last;
  live_pages(a, a.pos_q[b], first, last);
  int r0 = 0, r1 = 0;
  if (first <= last) {
    r0 = first / a.range_pages;
    r1 = last / a.range_pages + 1;
  }
  const float* ml = a.part_ml + bh * a.n_ranges * 2;
  const float* po = a.part_o + bh * a.n_ranges * a.D;
  float M = -INFINITY;
  for (int r = r0; r < r1; ++r) M = fmaxf(M, ml[2 * r]);
  float L = 0.f;
  if (M != -INFINITY)
    for (int r = r0; r < r1; ++r) L = fmaf(part_weight(ml[2 * r], M), ml[2 * r + 1], L);
  for (int d = threadIdx.x; d < a.D; d += blockDim.x) {
    float O = 0.f;
    if (M != -INFINITY)
      for (int r = r0; r < r1; ++r) O = fmaf(part_weight(ml[2 * r], M), po[r * a.D + d], O);
    store_out(a, bh * a.D + d, L > 0.f ? O / L : 0.f);
  }
}

template <typename TKV, int D, int GC>
cudaError_t launch_main(const Args& a, cudaStream_t st) {
  const dim3 grid(a.n_ranges, a.Hkv * (a.G / GC), a.B);
  paged_attn_kernel<TKV, D, GC><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename TKV, int D>
cudaError_t launch_d(const Args& a, int gc, cudaStream_t st) {
  switch (gc) {
    case 1: return launch_main<TKV, D, 1>(a, st);
    case 2: return launch_main<TKV, D, 2>(a, st);
    case 4: return launch_main<TKV, D, 4>(a, st);
    case 8: return launch_main<TKV, D, 8>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename TKV>
cudaError_t launch_kv(const Args& a, int gc, cudaStream_t st) {
  switch (a.D) {
    case 16: return launch_d<TKV, 16>(a, gc, st);
    case 32: return launch_d<TKV, 32>(a, gc, st);
    case 64: return launch_d<TKV, 64>(a, gc, st);
    case 128: return launch_d<TKV, 128>(a, gc, st);
    case 256: return launch_d<TKV, 256>(a, gc, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() of the launches (0 on
// success).  dtypes: 0 = f32, 1 = bf16 (q_dtype for q and out, kv_dtype for
// both pools); D in {16, 32, 64, 128, 256}; G = Hq / Hkv is served in
// chunks of gc in {1, 2, 4, 8} query heads a CTA (gc divides G).  The pages
// of a table row are cut into n_ranges ranges of range_pages; with
// n_ranges > 1, `scratch` holds B * Hq * n_ranges * (D + 2) floats for the
// ranges' partials, and a second kernel merges them.  ps_shift is
// log2(page_size) for a power of two, else -1.  All tensors contiguous,
// 16-byte aligned.
int repro_paged_attention_fwd(const void* q, const void* k, const void* v, const void* pos,
                              const void* table, const void* pos_q, void* out, void* scratch,
                              int q_dtype, int kv_dtype, int B, int Hq, int Hkv, int D, int gc,
                              int n_pages, int page_size, int ps_shift, int max_pages,
                              int range_pages, int n_ranges, int causal, int window, float scale,
                              void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || B > 65535 || n_pages <= 0 || page_size <= 0 ||
      max_pages <= 0 || range_pages <= 0 || n_ranges <= 0 ||
      static_cast<long long>(range_pages) * n_ranges < max_pages)
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  if ((gc != 1 && gc != 2 && gc != 4 && gc != 8) || G % gc || Hkv * (G / gc) > 65535)
    return cudaErrorInvalidValue;
  if ((q_dtype != 0 && q_dtype != 1) || (kv_dtype != 0 && kv_dtype != 1))
    return cudaErrorInvalidValue;
  if (n_ranges > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  float* part_o = static_cast<float*>(scratch);
  float* part_ml =
      part_o ? part_o + static_cast<long long>(B) * Hq * n_ranges * D : nullptr;
  const Args a{q,         k,           v,
               static_cast<const int*>(pos), static_cast<const int*>(table),
               static_cast<const int*>(pos_q), out, part_o, part_ml,
               B,         Hq,          Hkv,
               G,         D,           n_pages,
               page_size, ps_shift,    max_pages,
               range_pages, n_ranges,  causal,
               window,    q_dtype,     scale * 1.4426950408889634f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = kv_dtype == 1 ? launch_kv<__nv_bfloat16>(a, gc, st) : launch_kv<float>(a, gc, st);
  if (err != cudaSuccess || n_ranges == 1) return err;
  paged_attn_merge_kernel<<<static_cast<unsigned>(B) * Hq, 64, 0, st>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
