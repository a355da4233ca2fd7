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
// 5 * B * S * H * N * 4 bytes plus two states, against 3.35 TB/s; the
// arithmetic is about 5 N^2 FLOPs per (step, head) on the CUDA cores against
// 67 TFLOP/s f32.  At the rwkv6-1.6b prefill shape (S = 1000, H = 32, N = 64)
// the bytes bound it at about 0.0125 ms.  The recurrence, though, is a chain
// of S dependent steps, so a kernel that steps one token at a time is bound
// by the latency of one step times S long before either limit; the chunked
// tensor-core form (what the TPU kernel does per chunk) is the later redesign.
//
// What this design does about it: the columns m of the state are independent
// (S[:, m] evolves only from r_t, k_t, w_t and v_t[m]), so the state never
// leaves registers and no step needs a barrier.
//  * A block owns kCols = 16 columns of one (batch, head); its N threads
//    split each column's N rows into N / 16 groups of kRows = 16, so a thread
//    keeps 16 state values in registers and one step costs it 16 rows of
//    multiply-adds.  The row groups of a column sit in adjacent lanes and add
//    their parts of y_t[m] with __shfl_xor_sync.
//  * The grid is (N / 16, H, B): at B = 1, H = 32, N = 64 that is 128 blocks
//    on 132 SMs, where one block per head would fill 32.  Splitting rows as
//    well as columns is what shortens the sequential step: with one thread
//    per whole column (64 rows) every step would cost each thread 4x the
//    instructions, whatever the grid.
//  * Steps are staged kTile = 16 at a time in shared memory with 16-byte
//    cp.async copies, double-buffered: the next tile is in flight while this
//    one computes.  Each staged tile then gets one expf per (step, n),
//    computed once for the whole block, not once per column.
//  * Each thread reads its rows from shared memory as float4 in a rotated
//    order (row group g starts at its own 4g-th row), so the four row groups
//    of a quarter-warp hit distinct banks.
//  * The state is read from s0 once and written to s_out once; y_t[m] is
//    written by the first lane of each column, 16 consecutive floats a block.
//  * The step loop is unrolled by two: with one warp per scheduler nothing
//    else hides a step's shared-memory and shuffle latency.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 16;  // steps staged per shared-memory tile
constexpr int kCols = 16;  // state columns per block
constexpr int kRows = 16;  // state rows per thread

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* s0;
  float* y;
  float* s_out;
  int B, S, H;
};

template <int N>
struct Tile {
  float r[kTile][N];
  float k[kTile][N];
  float w[kTile][N];  // log_w as copied, e^{log_w} after the block's pass
  float v[kTile][kCols];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Offset of element (b, s, h, 0) of a (B, S, H, N) tensor.
template <int N>
__device__ __forceinline__ long long seq_offset(const Args& a, int b, int s, int h) {
  return ((static_cast<long long>(b) * a.S + s) * a.H + h) * N;
}

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

template <int N>
__global__ void __launch_bounds__(N) wkv_fwd_kernel(const Args a) {
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

template <int N>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(N / kCols, a.H, a.B);
  wkv_fwd_kernel<N><<<grid, N, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success).  All tensors f32, contiguous and 16-byte aligned; N in {16, 32, 64}.
int repro_linear_scan_fwd(const void* r, const void* k, const void* v, const void* log_w,
                          const void* u, const void* s0, void* y, void* s_out, int B, int S,
                          int H, int N, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(r),  static_cast<const float*>(k),
               static_cast<const float*>(v),  static_cast<const float*>(log_w),
               static_cast<const float*>(u),  static_cast<const float*>(s0),
               static_cast<float*>(y),        static_cast<float*>(s_out),
               B, S, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 16) return launch<16>(a, st);
  if (N == 32) return launch<32>(a, st);
  if (N == 64) return launch<64>(a, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
