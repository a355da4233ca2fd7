// RWKV-6 WKV scan for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/linear_scan.py::_wkv_kernel
// (entry linear_scan, dispatched from kernels/ops.py) and computes the same
// function, the RWKV-6 recurrence with a per-head N x N f32 state:
//
//   y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
//   S_t = diag(e^{log_w_t}) S_{t-1} + k_t v_t^T
//
// r, k, v, log_w: (B, S, H, N) f32, contiguous, log_w <= 0; u: (H, N);
// s0: (B, H, N, N) -> y: (B, S, H, N), s_out: (B, H, N, N), all f32.
// N is 16, 32 or 64 (rwkv6-1.6b: 64).
//
// What bounds it on an H100 SXM: each input is read once and y written once,
// 5 * B * S * H * N * 4 bytes plus two states, against 3.35 TB/s: about
// 0.0125 ms at the rwkv6-1.6b prefill shape (B 1, S 1000, H 32, N 64).  The
// recurrence, though, is a chain of S dependent steps: stepped one token at
// a time it is bound by one step's latency times S (the "step" body below,
// about 0.18 ms there), and all its arithmetic sits on the CUDA cores.
//
// What the chunked body does about it (the default): like the TPU kernel it
// works on chunks of kChunk = 64 steps as matrix products, and carries the
// state only from chunk to chunk, so S dependent steps become S / 64
// elementwise state updates.  Three launches on the caller's stream:
//  1. wkv_chunk_kernel, one CTA per (b, chunk, h): the chunk's own state
//     update U = k_hat^T V, k_hat = k * e^{p_last - p} (p the inclusive
//     cumulative log-decay inside the chunk), and its decay g = e^{p_last};
//  2. wkv_state_scan_kernel, per (b, h, 4 state elements): walks the chunks
//     in order, S <- g * S + U, overwriting each U with the chunk's start
//     state and writing s_out; elementwise, so the only sequential part
//     moves 16 KB of scratch a chunk and head, small enough for L2;
//  3. wkv_out_kernel, one CTA per (b, chunk, h): y = (r * e^{p_prev})
//     S_start + A V, where A is the chunk's C x C decay-weighted r k^T with
//     the u-bonus on its diagonal.
// With one chunk (S <= 64: every chunk round of the paged engine) only the
// output kernel runs: it reads s0 as the start state and also writes
// s_out = g * s0 + U, so each input is read once.
// Splitting the state pass into a parallel chunk product (1) and an
// elementwise scan (2) keeps the tensor-core work on B * chunks * H CTAs
// (512 at the prefill shape) instead of B * H = 32 walking the chunks.
// Each CTA has 8 warps, 2 CTAs an SM.  In the output kernel all warps share
// the diagonal tiles (4 x 4 blocks of pairs a lane group), six take one
// off-diagonal tile each, and each then computes 16 rows by N / 2 columns
// of y, row blocks paired {0, 3}, {1, 2} on a scheduler so the A V
// product's triangle is balanced.
// What still bounds it: the three kernels move about twice the bound's
// bytes (k, log_w and v are read by passes 1 and 3, and the scratch state
// is written and read twice), and inside the output kernel the diagonal tiles' exps
// and shared-memory reads and the 3xTF32 products run after the loads
// rather than under them (PERF.md has the breakdown).
//
// Numerics: every exp argument is <= 0 for any log_w <= 0.  p is summed in
// order, so it never rises; A's off-diagonal 16 x 16 tiles (query sub-chunk
// i, key sub-chunk j < i) factor as (r_t e^{p_prev,t - a}) (k_s e^{a - p_s})^T
// around the anchor a = p_prev at i's first row, both exponents <= 0; the
// diagonal tiles are elementwise e^{p_prev,t - p_s} on the CUDA cores.  A
// whole chunk is never factored as (r e^p)(k e^-p)^T: e^-p overflows f32
// under rwkv6's data-dependent decays.  The products run on the tensor cores
// as 3xTF32 mma.sync.m16n8k8 (a = big + small, big the top 10 mantissa bits;
// small*big + big*small + big*big, f32 accumulation), which keeps the f32
// tolerance that one TF32 pass would miss.  exp is ex2.approx on log2-scaled
// decays.  Rows past S load as zeros (cp.async zero fill): log_w = 0 and
// k = 0 leave the state unchanged, and their y rows are not stored.
// Loads are staged in two cp.async groups: the second (v and the start
// state) is in flight while the cumulative sums and A are computed.
//
// The step body (wkv_step_kernel, on request only, for timing the two
// against each other): the columns m of the state are independent, so a
// block owns 16 columns of one (b, h) with the state in registers, 16 rows
// a thread, grid (N / 16, H, B), steps staged 16 at a time with cp.async,
// double-buffered.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* s0;
  float* y;
  float* s_out;
  float* states;  // chunked body: (B, nc, H, N, N) U, then start states
  float* decay;   // chunked body: (B, nc, H, N) e^{p_last}
  int B, S, H, nc;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// 16-byte copy that writes zeros instead when `valid` is false (src-size 0).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Offset of element (b, s, h, 0) of a (B, S, H, N) tensor.
template <int N>
__device__ __forceinline__ long long seq_offset(const Args& a, int b, int s, int h) {
  return ((static_cast<long long>(b) * a.S + s) * a.H + h) * N;
}

// ---------------------------------------------------------------------------
// The chunked body.

constexpr int kChunk = 64;  // steps per chunk
constexpr int kSub = 16;    // rows per sub-chunk: the unit of A's tiles
constexpr int kThreads = 256;  // chunk and output kernels: 8 warps
constexpr int kScanThreads = 128;  // state scan
constexpr float kLog2e = 1.4426950408889634f;

// Row strides of the shared-memory tiles, in floats.  An mma fragment reads
// 8 rows x 4 columns (row stride = 4 mod 32 banks) or 4 rows x 8 columns
// (= 8 mod 32): both conflict-free.
template <int N>
struct Ld {
  static constexpr int kRow = N + 4;  // read as [row][k] or [col][k]
  static constexpr int kCol = N + 8;  // read as [k][col]
};
constexpr int kLdA = kChunk + 4;  // the C x C matrix A, read as [t][s]

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 3xTF32: x = big + small, each a TF32 value (low 13 mantissa bits clear);
// x - big is exact.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: acc[j] (16 x 8, columns 8j..8j+7) += A (16 x 8 k_steps) B, with
// fa(row, k) and fb(k, col) giving the operands' elements (each A element is
// read once per warp, each B element once per n-tile).  Fragment layout of
// mma.m16n8k8 tf32: lane = 4 g + q; a = A[g][q], A[g+8][q], A[g][q+4],
// A[g+8][q+4]; b = B[q][g], B[q+4][g]; c = C[g][2q], C[g][2q+1],
// C[g+8][2q], C[g+8][2q+1].  The big * big products and the two correction
// terms go to separate accumulators, each issued across the n-tiles, so no
// mma waits on the one just before it.
template <int NT, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int k_steps, FA fa, FB fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float lo[NT][4] = {};
#pragma unroll 2
  for (int ks = 0; ks < k_steps; ++ks) {
    const int k0 = ks * 8;
    uint32_t ab[4], as[4], bb[NT][2], bs[NT][2];
    split_tf32(fa(g, k0 + q), ab[0], as[0]);
    split_tf32(fa(g + 8, k0 + q), ab[1], as[1]);
    split_tf32(fa(g, k0 + q + 4), ab[2], as[2]);
    split_tf32(fa(g + 8, k0 + q + 4), ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split_tf32(fb(k0 + q, 8 * j + g), bb[j][0], bs[j][0]);
      split_tf32(fb(k0 + q + 4, 8 * j + g), bb[j][1], bs[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(lo[j], as, bb[j]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(lo[j], ab, bs[j]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ab, bb[j]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += lo[j][e];
}

// Copy kChunk rows of N floats of a (B, S, H, N) tensor, from step t0 on,
// into dst with row stride ld; rows at or past S are zero filled.
template <int N>
__device__ __forceinline__ void load_chunk(float* dst, int ld, const float* src, const Args& a,
                                           int b, int h, int t0) {
  constexpr int kChunks = N / 4;
  for (int i = threadIdx.x; i < kChunk * kChunks; i += kThreads) {
    const int row = i / kChunks, c = (i % kChunks) * 4;
    const bool valid = t0 + row < a.S;
    const float* g = src + (valid ? seq_offset<N>(a, b, t0 + row, h) + c : 0);
    cp_async16_zfill(dst + row * ld + c, g, valid);
  }
}

// Copy an N x N state (row stride N in memory) into dst (row stride ld).
template <int N>
__device__ __forceinline__ void load_state(float* dst, int ld, const float* src) {
  for (int i = threadIdx.x; i < N * N / 4; i += kThreads) {
    const int row = i / (N / 4), col = (i % (N / 4)) * 4;
    cp_async16(dst + row * ld + col, src + row * N + col);
  }
}

// In-place inclusive cumulative sum down the kChunk rows of `p` (row stride
// ld), in log2 units: p[t] = sum_{s<=t} log_w[s] * log2(e).  Each column is
// cut into kThreads / N segments, each summed in order in registers; then
// each segment adds the final value of the one before it, which every
// thread rebuilds with the same additions.  So p never rises down a column
// (adding x <= 0 never rounds up), and a later row minus an earlier one is
// never positive.
template <int N>
__device__ __forceinline__ void cumsum_log2(float* p, int ld) {
  constexpr int kSegs = kThreads / N, kLen = kChunk / kSegs;
  const int n = threadIdx.x % N, seg = threadIdx.x / N;
  float x[kLen];
#pragma unroll
  for (int i = 0; i < kLen; ++i) x[i] = p[(seg * kLen + i) * ld + n];
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kLen; ++i) x[i] = acc = fmaf(x[i], kLog2e, acc);
#pragma unroll
  for (int i = 0; i < kLen; ++i) p[(seg * kLen + i) * ld + n] = x[i];
  __syncthreads();
  float total = p[(kLen - 1) * ld + n];  // segment 0's last row
  for (int m = 1; m < seg; ++m) total = total + p[(m * kLen + kLen - 1) * ld + n];
  __syncthreads();  // every thread has read the segments' own sums
  if (seg > 0) {
#pragma unroll
    for (int i = 0; i < kLen; ++i) p[(seg * kLen + i) * ld + n] = total + x[i];
  }
  __syncthreads();
}

// The N x N state update U = k_hat^T V over the warps: warp w takes the
// 16 rows from 16 (w % 4) (none past N) and the half w / 4 of the columns.
template <int N>
struct UTiles {
  static constexpr int NT = N / 16;  // n-tiles of 8 columns a warp
  __device__ static bool active(int w) { return kSub * (w % 4) < N; }
  __device__ static int row0(int w) { return kSub * (w % 4); }
  __device__ static int col0(int w) { return (N / 2) * (w / 4); }
};

template <int N>
struct ChunkSmem {
  float kh[kChunk][Ld<N>::kCol];  // k, then k_hat; read as A[n][t] = kh[t][n]
  float v[kChunk][Ld<N>::kCol];
  float p[kChunk][Ld<N>::kRow];   // log_w, then its cumulative sum (log2)
};

// Pass 1 (nc > 1): per (chunk c, head h, batch b), U = k_hat^T V and
// g = e^{p_last}.
template <int N>
__global__ void __launch_bounds__(kThreads, 2) wkv_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<N>& sm = *reinterpret_cast<ChunkSmem<N>*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kChunk;

  load_chunk<N>(&sm.kh[0][0], Ld<N>::kCol, a.k, a, b, h, t0);
  load_chunk<N>(&sm.p[0][0], Ld<N>::kRow, a.lw, a, b, h, t0);
  cp_async_commit();
  load_chunk<N>(&sm.v[0][0], Ld<N>::kCol, a.v, a, b, h, t0);
  cp_async_commit();
  cp_async_wait_one();
  __syncthreads();

  cumsum_log2<N>(&sm.p[0][0], Ld<N>::kRow);
  const long long bch = (static_cast<long long>(b) * a.nc + c) * a.H + h;
  if (threadIdx.x < N)
    a.decay[bch * N + threadIdx.x] = ex2(sm.p[kChunk - 1][threadIdx.x]);
  for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {
    const int t = i / N, n = i % N;
    sm.kh[t][n] *= ex2(sm.p[kChunk - 1][n] - sm.p[t][n]);
  }
  cp_async_wait_all();
  __syncthreads();

  using UT = UTiles<N>;
  constexpr int NT = UT::NT;
  const int w = threadIdx.x / 32, n0 = UT::row0(w), m0 = UT::col0(w);
  if (!UT::active(w)) return;
  float acc[NT][4] = {};
  warp_mma<NT>(
      acc, kChunk / 8, [&](int row, int t) { return sm.kh[t][n0 + row]; },
      [&](int t, int m) { return sm.v[t][m0 + m]; });
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float* U = a.states + bch * N * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = n0 + g + 8 * half;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(U + n * N + m0 + 8 * j + 2 * q) =
          make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

// Pass 2 (nc > 1): per (b, h) and 4 consecutive state elements, walk the
// chunks: states[c] <- S (the start state of chunk c), S <- g_c * S + U_c.
template <int N>
__global__ void __launch_bounds__(kScanThreads) wkv_state_scan_kernel(const Args a) {
  const int idx = blockIdx.x * kScanThreads + threadIdx.x;  // float4 index in N x N
  if (idx >= N * N / 4) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n = idx * 4 / N;
  const long long bh = static_cast<long long>(b) * a.H + h;
  float4 s = reinterpret_cast<const float4*>(a.s0 + bh * N * N)[idx];
  constexpr int kBatch = 4;  // chunks whose loads are issued together
  for (int c0 = 0; c0 < a.nc; c0 += kBatch) {
    float4 u4[kBatch];
    float g[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i < a.nc) {
        const long long bch = (static_cast<long long>(b) * a.nc + c0 + i) * a.H + h;
        u4[i] = reinterpret_cast<const float4*>(a.states + bch * N * N)[idx];
        g[i] = a.decay[bch * N + n];
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i < a.nc) {
        const long long bch = (static_cast<long long>(b) * a.nc + c0 + i) * a.H + h;
        reinterpret_cast<float4*>(a.states + bch * N * N)[idx] = s;
        s = make_float4(fmaf(g[i], s.x, u4[i].x), fmaf(g[i], s.y, u4[i].y),
                        fmaf(g[i], s.z, u4[i].z), fmaf(g[i], s.w, u4[i].w));
      }
    }
  }
  reinterpret_cast<float4*>(a.s_out + bh * N * N)[idx] = s;
}

template <int N>
struct OutSmem {
  float r[kChunk][Ld<N>::kRow];
  float k[kChunk][Ld<N>::kRow];
  // pp[t] = p_{t-1} (pp[0] = 0), so p_s = pp[s + 1]; log2 units
  float pp[kChunk + 1][Ld<N>::kRow];
  float A[kChunk][kLdA];  // decay-weighted r k^T, u-bonus on the diagonal
  float v[kChunk][Ld<N>::kCol];
  float st[N][Ld<N>::kCol];  // the chunk's start state
  float u[N];
};

// The off-diagonal tiles of A, one a warp: (query sub-chunk i, key
// sub-chunk j), j < i.
__constant__ int kOffDiag[6][2] = {{1, 0}, {2, 0}, {2, 1}, {3, 0}, {3, 1}, {3, 2}};
constexpr int kOffWarps = 6;

// The diagonal 16 x 16 tiles of A, elementwise on the CUDA cores:
// A[t][s] = sum_n r_t k_s e^{pp_t - p_s} for s < t, sum_n r_t u k_t for
// s = t.  A tile's lower triangle is cut into ten 4 x 4 blocks; kSlices
// adjacent lanes take one block, each over every kSlices-th float4 of n, and add
// their sums with shuffles.  A thread reads 4 rows of each operand for 16
// pairs, a quarter of the shared-memory traffic of one pair a thread.  The
// rotation gives the last round to the warps without an off-diagonal tile.
template <int N>
__device__ __forceinline__ void diag_tiles(OutSmem<N>& sm) {
  constexpr int kSlices = N / 4 < 8 ? N / 4 : 8, kW = N / kSlices;
  constexpr int kItems = 4 * 10 * kSlices;
  for (int item = (threadIdx.x + kThreads - 32 * kOffWarps) % kThreads; item < kItems;
       item += kThreads) {
    const int blk = item / kSlices, sl = item % kSlices;
    const int bk = blk % 10;
    int bi = 0;
    while ((bi + 1) * (bi + 2) / 2 <= bk) ++bi;
    const int bj = bk - bi * (bi + 1) / 2;  // bj <= bi
    const int t0 = (blk / 10) * kSub + 4 * bi, s0 = (blk / 10) * kSub + 4 * bj;
    float acc[4][4] = {};
#pragma unroll
    for (int c = 0; c < kW / 4; ++c) {
      const int n = 4 * sl + 4 * kSlices * c;  // a quarter-warp reads 128 contiguous bytes
      float4 r4[4], a4[4], k4[4], b4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        r4[i] = *reinterpret_cast<const float4*>(&sm.r[t0 + i][n]);
        a4[i] = *reinterpret_cast<const float4*>(&sm.pp[t0 + i][n]);
        k4[i] = *reinterpret_cast<const float4*>(&sm.k[s0 + i][n]);
        b4[i] = *reinterpret_cast<const float4*>(&sm.pp[s0 + i + 1][n]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (s0 + j < t0 + i) {  // only s < t: e^{pp_t - p_s} <= 1
            float x = acc[i][j];
            x = fmaf(r4[i].x * k4[j].x, ex2(a4[i].x - b4[j].x), x);
            x = fmaf(r4[i].y * k4[j].y, ex2(a4[i].y - b4[j].y), x);
            x = fmaf(r4[i].z * k4[j].z, ex2(a4[i].z - b4[j].z), x);
            acc[i][j] = fmaf(r4[i].w * k4[j].w, ex2(a4[i].w - b4[j].w), x);
          }
      if (bi == bj) {  // the u-bonus on the diagonal
        const float4 u4 = *reinterpret_cast<const float4*>(&sm.u[n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i][i] += (r4[i].x * u4.x * k4[i].x + r4[i].y * u4.y * k4[i].y) +
                       (r4[i].z * u4.z * k4[i].z + r4[i].w * u4.w * k4[i].w);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int off = 1; off < kSlices; off <<= 1)
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (sl == i) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (s0 + j <= t0 + i) sm.A[t0 + i][s0 + j] = acc[i][j];
      }
  }
}


// Pass 3: per (chunk c, head h, batch b), y of the chunk's rows.
template <int N>
__global__ void __launch_bounds__(kThreads, 2) wkv_out_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OutSmem<N>& sm = *reinterpret_cast<OutSmem<N>*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tc = c * kChunk;
  const long long bh = static_cast<long long>(b) * a.H + h;

  load_chunk<N>(&sm.r[0][0], Ld<N>::kRow, a.r, a, b, h, tc);
  load_chunk<N>(&sm.k[0][0], Ld<N>::kRow, a.k, a, b, h, tc);
  load_chunk<N>(&sm.pp[1][0], Ld<N>::kRow, a.lw, a, b, h, tc);
  if (threadIdx.x < N / 4) cp_async16(&sm.u[4 * threadIdx.x], a.u + h * N + 4 * threadIdx.x);
  cp_async_commit();
  load_chunk<N>(&sm.v[0][0], Ld<N>::kCol, a.v, a, b, h, tc);
  const long long bch = (static_cast<long long>(b) * a.nc + c) * a.H + h;
  load_state<N>(&sm.st[0][0], Ld<N>::kCol,
                a.nc == 1 ? a.s0 + bh * N * N : a.states + bch * N * N);
  cp_async_commit();
  cp_async_wait_one();
  if (threadIdx.x < N) sm.pp[0][threadIdx.x] = 0.f;
  __syncthreads();
  cumsum_log2<N>(&sm.pp[1][0], Ld<N>::kRow);

  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;

  for (int e = threadIdx.x; e < kChunk * kSub; e += kThreads) {
    const int t = e / kSub, j = e % kSub, s = (t / kSub) * kSub + j;
    if (s > t) sm.A[t][s] = 0.f;  // above the diagonal tiles' diagonal
  }
  diag_tiles<N>(sm);
  // Off-diagonal tiles on the tensor cores, anchored at a = pp[16 i].
  if (w < kOffWarps) {
    const int t0 = kSub * kOffDiag[w][0], s0 = kSub * kOffDiag[w][1];
    float acc[2][4] = {};
    warp_mma<2>(
        acc, N / 8,
        [&](int row, int n) { return sm.r[t0 + row][n] * ex2(sm.pp[t0 + row][n] - sm.pp[t0][n]); },
        [&](int n, int s) { return sm.k[s0 + s][n] * ex2(sm.pp[t0][n] - sm.pp[s0 + s + 1][n]); });
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int s = s0 + 8 * j + 2 * q;
      *reinterpret_cast<float2*>(&sm.A[t0 + g][s]) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(&sm.A[t0 + g + 8][s]) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  cp_async_wait_all();  // v and the start state
  __syncthreads();

  // y = (r e^{pp}) S_start + A V.  Warp w: the 16 rows of sub-chunk rb and
  // half (w >> 1) & 1 of the N columns.  Warps w and w + 4 share a
  // scheduler; their row blocks are {0, 3} or {1, 2}, so the A V product's
  // length (rb + 1 k-steps of 16) is balanced over the schedulers.
  constexpr int NT = N / 16;
  const int rb = w < 4 ? (w & 1) : 3 - (w & 1);
  const int t0 = kSub * rb, m0 = (N / 2) * ((w >> 1) & 1);
  const int g = lane >> 2, q = lane & 3;
  float acc[NT][4] = {};
  warp_mma<NT>(
      acc, N / 8, [&](int row, int n) { return sm.r[t0 + row][n] * ex2(sm.pp[t0 + row][n]); },
      [&](int n, int m) { return sm.st[n][m0 + m]; });
  warp_mma<NT>(
      acc, (t0 + kSub) / 8, [&](int row, int s) { return sm.A[t0 + row][s]; },
      [&](int s, int m) { return sm.v[s][m0 + m]; });
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = tc + t0 + g + 8 * half;
    if (t >= a.S) continue;
    float* yrow = a.y + seq_offset<N>(a, b, t, h) + m0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(yrow + 8 * j + 2 * q) =
          make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
  }
  if (a.nc > 1) return;

  // One chunk: s_out = g * s0 + k_hat^T V here, with no chunk kernel and no
  // scan, laid out over the warps as in the chunk kernel; k_hat = k *
  // e^{p_last - p} is formed as the product reads it.
  using UT = UTiles<N>;
  if (!UT::active(w)) return;
  const int n0 = UT::row0(w), c0 = UT::col0(w);
  float u_acc[UT::NT][4] = {};
  warp_mma<UT::NT>(
      u_acc, kChunk / 8,
      [&](int row, int t) {
        return sm.k[t][n0 + row] * ex2(sm.pp[kChunk][n0 + row] - sm.pp[t + 1][n0 + row]);
      },
      [&](int t, int m) { return sm.v[t][c0 + m]; });
  float* out = a.s_out + bh * N * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = n0 + g + 8 * half;
    const float gn = ex2(sm.pp[kChunk][n]);
#pragma unroll
    for (int j = 0; j < UT::NT; ++j) {
      const int m = c0 + 8 * j + 2 * q;
      *reinterpret_cast<float2*>(out + n * N + m) =
          make_float2(fmaf(gn, sm.st[n][m], u_acc[j][2 * half]),
                      fmaf(gn, sm.st[n][m + 1], u_acc[j][2 * half + 1]));
    }
  }
}

// ---------------------------------------------------------------------------
// The step body: one token at a time, the state in registers.

constexpr int kTile = 16;  // steps staged per shared-memory tile
constexpr int kCols = 16;  // state columns per block
constexpr int kRows = 16;  // state rows per thread

template <int N>
struct Tile {
  float r[kTile][N];
  float k[kTile][N];
  float w[kTile][N];  // log_w as copied, e^{log_w} after the block's pass
  float v[kTile][kCols];
};

// Start the copies of steps [t0, t0 + kTile) (those below S) into `t`.
template <int N>
__device__ __forceinline__ void load_tile(Tile<N>& t, const Args& a, int b, int h, int c0,
                                          int t0) {
  constexpr int kChunks = N / 4;      // 16-byte chunks per row of r, k, log_w
  constexpr int kVChunks = kCols / 4;  // ... and of this block's v columns
  const int rows = min(kTile, a.S - t0);
  for (int i = threadIdx.x; i < rows * kChunks; i += N) {
    const int row = i / kChunks, c = (i % kChunks) * 4;
    const long long g = seq_offset<N>(a, b, t0 + row, h) + c;
    cp_async16(&t.r[row][c], a.r + g);
    cp_async16(&t.k[row][c], a.k + g);
    cp_async16(&t.w[row][c], a.lw + g);
  }
  for (int i = threadIdx.x; i < rows * kVChunks; i += N) {
    const int row = i / kVChunks, c = (i % kVChunks) * 4;
    cp_async16(&t.v[row][c], a.v + seq_offset<N>(a, b, t0 + row, h) + c0 + c);
  }
}

// A block owns kCols = 16 columns of one (b, h); its N threads split each
// column's N rows into N / 16 groups of kRows = 16 rows held in registers,
// and the row groups of a column (adjacent lanes) add their parts of y_t[m]
// with __shfl_xor_sync.  Each staged tile gets one expf per (step, n) for the
// whole block.  Rows are read as float4 in a rotated order (row group g
// starts at its 4g-th row) so a quarter-warp hits distinct banks.
template <int N>
__global__ void __launch_bounds__(N) wkv_step_kernel(const Args a) {
  constexpr int R = N / kRows;  // threads (row groups) per column
  __shared__ __align__(16) Tile<N> tiles[2];

  const int c0 = blockIdx.x * kCols, h = blockIdx.y, b = blockIdx.z;
  const int col = threadIdx.x / R;  // local column
  const int grp = threadIdx.x % R;  // row group
  const int m = c0 + col;
  const int n0 = grp * kRows;
  const unsigned mask = N >= 32 ? 0xffffffffu : ((1u << N) - 1u);

  // Register i of this thread holds row n0 + rot(i): the rotation by 4 * grp
  // puts the row groups' float4 reads on distinct banks.
  auto row_of = [&](int i) { return n0 + ((i + 4 * grp) & (kRows - 1)); };

  const long long st = (static_cast<long long>(b) * a.H + h) * N * N;
  float s[kRows], uu[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    s[i] = a.s0[st + static_cast<long long>(row_of(i)) * N + m];
    uu[i] = a.u[h * N + row_of(i)];
  }

  const int n_tiles = (a.S + kTile - 1) / kTile;
  load_tile<N>(tiles[0], a, b, h, c0, 0);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    Tile<N>& t = tiles[it & 1];
    if (it + 1 < n_tiles) load_tile<N>(tiles[(it + 1) & 1], a, b, h, c0, (it + 1) * kTile);
    cp_async_commit();  // possibly empty: keeps "all but the newest group" = this tile
    cp_async_wait_one();
    __syncthreads();

    const int t0 = it * kTile;
    const int rows = min(kTile, a.S - t0);
    float* w = &t.w[0][0];
    for (int i = threadIdx.x; i < rows * N; i += N) w[i] = expf(w[i]);
    __syncthreads();

    // two steps per trip: one step's loads and shuffles overlap the next's
#pragma unroll 2
    for (int j = 0; j < rows; ++j) {
      const float vm = t.v[j][col];
      float acc0 = 0.f, acc1 = 0.f, bon0 = 0.f, bon1 = 0.f;
#pragma unroll
      for (int q = 0; q < kRows; q += 4) {
        const int n = row_of(q);
        const float4 r4 = *reinterpret_cast<const float4*>(&t.r[j][n]);
        const float4 k4 = *reinterpret_cast<const float4*>(&t.k[j][n]);
        const float4 w4 = *reinterpret_cast<const float4*>(&t.w[j][n]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q + e;
          // y uses S_{t-1}; the update follows
          if (e & 1) {
            acc1 = fmaf(rr[e], s[i], acc1);
            bon1 = fmaf(rr[e] * uu[i], kk[e], bon1);
          } else {
            acc0 = fmaf(rr[e], s[i], acc0);
            bon0 = fmaf(rr[e] * uu[i], kk[e], bon0);
          }
          s[i] = fmaf(ww[e], s[i], kk[e] * vm);
        }
      }
      float yp = (acc0 + acc1) + vm * (bon0 + bon1);
#pragma unroll
      for (int off = R / 2; off > 0; off >>= 1) yp += __shfl_xor_sync(mask, yp, off);
      if (grp == 0) a.y[seq_offset<N>(a, b, t0 + j, h) + m] = yp;
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) a.s_out[st + static_cast<long long>(row_of(i)) * N + m] = s[i];
}

// ---------------------------------------------------------------------------
// Launch.

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

template <int N>
cudaError_t launch_chunked(const Args& a, cudaStream_t stream) {
  constexpr size_t chunk_smem = sizeof(ChunkSmem<N>), out_smem = sizeof(OutSmem<N>);
  cudaError_t err = raise_smem_limit<wkv_chunk_kernel<N>>(chunk_smem);
  if (err == cudaSuccess) err = raise_smem_limit<wkv_out_kernel<N>>(out_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nc, a.H, a.B);
  if (a.nc > 1) {
    wkv_chunk_kernel<N><<<grid, kThreads, chunk_smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const dim3 scan_grid((N * N / 4 + kScanThreads - 1) / kScanThreads, a.H, a.B);
    wkv_state_scan_kernel<N><<<scan_grid, kScanThreads, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  wkv_out_kernel<N><<<grid, kThreads, out_smem, stream>>>(a);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_step(const Args& a, cudaStream_t stream) {
  const dim3 grid(N / kCols, a.H, a.B);
  wkv_step_kernel<N><<<grid, N, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch(const Args& a, int body, cudaStream_t stream) {
  return body == 1 ? launch_step<N>(a, stream) : launch_chunked<N>(a, stream);
}

}  // namespace

extern "C" {

// Steps per chunk of the chunked body: the wrapper sizes its scratch by it.
int repro_linear_scan_chunk() { return kChunk; }

// Launches on `stream` and returns cudaGetLastError() of the launches (0 on
// success).  All tensors f32, contiguous and 16-byte aligned; N in {16, 32,
// 64}.  `body` 0 runs the chunked body, the default at every shape; 1 runs
// the step body, only when the caller asks for it (to time the two).
// The chunked body needs `scratch` of B * nc * H * N * (N + 1) floats,
// nc = ceil(S / repro_linear_scan_chunk()), none when nc == 1; the step
// body ignores it.
int repro_linear_scan_fwd(const void* r, const void* k, const void* v, const void* log_w,
                          const void* u, const void* s0, void* y, void* s_out, void* scratch,
                          int B, int S, int H, int N, int body, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  if (body != 0 && body != 1) return cudaErrorInvalidValue;
  const int nc = (S + kChunk - 1) / kChunk;
  if (body == 0 && nc > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  float* states = static_cast<float*>(scratch);
  float* decay = states ? states + static_cast<long long>(B) * nc * H * N * N : nullptr;
  const Args a{static_cast<const float*>(r),  static_cast<const float*>(k),
               static_cast<const float*>(v),  static_cast<const float*>(log_w),
               static_cast<const float*>(u),  static_cast<const float*>(s0),
               static_cast<float*>(y),        static_cast<float*>(s_out),
               states,                        decay,
               B, S, H, nc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 16) return launch<16>(a, body, st);
  if (N == 32) return launch<32>(a, body, st);
  if (N == 64) return launch<64>(a, body, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
