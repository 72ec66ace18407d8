// Batched SPD solve  A x = b  by a left-looking Cholesky, one system per
// lane of a warp.
//
// Replaces: docs/negative_results/pallas_linalg_lanes.py ::
// _spd_solve_kernel (the Pallas TPU kernel behind
// `batched_spd_solve(force_pallas=True)`, pallas_call at
// pallas_linalg_lanes.py:90).  It computes the same thing in the same
// order: column by column,
//     acc   = A_jj - sum_{k<j} L_jk^2            (k ascending)
//     ljj   = sqrt(max(acc, 1e-20)),  inv = 1 / ljj
//     L_ij  = (A_ij - sum_{k<j} L_ik L_jk) * inv  for i >= j
// so the stored diagonal is acc * inv (it equals ljj only where the clamp
// did not act), then  y_i = (b_i - sum_{k<i} L_ik y_k) / L_ii  and
// x_i = (y_i - sum_{k>i} L_ki x_k) / L_ii  (k ascending in both).  This
// clamp differs from spd_cholesky.cu's rsqrt(max(., 1e-30)): the two
// kernels differ on indefinite systems and share no body.  Multiplies and
// subtracts are separate round-to-nearest operations (no FMA contraction),
// sqrt and the divisions are IEEE-rounded, so the kernel does the
// arithmetic of `batched_spd_solve_plain` in dyobav_tpu_torch/ops/
// spd_lanes.py, operation for operation.
//
// Design: "batch in lanes" read for Hopper.  A block of 4 warps holds 32
// systems; lane l of every warp belongs to system l.  The lower triangles
// (all the solve reads) and right-hand sides are staged from the row-major
// (B, n, n) input into shared memory by all 4 warps, a row per warp-load so
// the global reads coalesce, in an [element][system] layout with a system
// stride of 33 floats: a warp writing one system's row and a warp reading
// one element of 32 systems both hit 32 distinct banks.  The 4 warps then
// split the rows of each column (4 threads per system, two block barriers
// per column), warp 0 does both substitutions, and all warps write x back
// coalesced.  At n = 40 a block holds (820 + 40) * 33 floats = 113.5 KB of
// dynamic shared memory, so 2 blocks (8 warps, 64 systems) fit on an SM.
// The TPU kernel's (n, n, 128) transposed blocks and its padding with
// identity systems are not carried over: the ragged last block is masked.
//
// Bound on an H100 SXM at (8192, 40, 40): the bytes that must move are the
// 32-byte sectors holding each lower triangle (31.5 MB) + b + x (2.6 MB),
// about 10 us at 3.35 TB/s; the about 2.1e8 flops take about 3 us at the
// 67 TFLOP/s f32 rate outside the tensor cores.  So it is bound by memory;
// what it actually waits on is shared-memory latency in the k-loops with 8
// warps per SM, which a register-tiled formulation would cut (later work).
//
// Build (plain C entry point, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libspd_lanes.so spd_lanes.cu

#include <cuda_runtime.h>

namespace {

constexpr int kSystems = 32;             // systems per block, one per lane
constexpr int kWarps = 4;                // threads per system
constexpr int kStride = kSystems + 1;    // floats between elements in smem
constexpr int kThreads = kSystems * kWarps;

__device__ __forceinline__ float sub_mul(float a, float b, float c) {
  return __fsub_rn(a, __fmul_rn(b, c));
}

__global__ void __launch_bounds__(kThreads)
spd_lanes_solve_kernel(const float* __restrict__ A,
                       const float* __restrict__ rhs,
                       float* __restrict__ x, int n, long long batch) {
  extern __shared__ float smem[];
  const int tri = n * (n + 1) / 2;
  float* L = smem;                   // packed lower triangle, row-major
  float* y = smem + tri * kStride;   // n
  const int lane = threadIdx.x % kSystems;
  const int warp = threadIdx.x / kSystems;
  const long long b0 = static_cast<long long>(blockIdx.x) * kSystems;
  const long long left = batch - b0;
  const int count = left < kSystems ? static_cast<int>(left) : kSystems;

  // Stage: warp w loads systems w, w + 4, ...; one row (up to its
  // diagonal) per pass, neighbouring lanes on neighbouring addresses.
  for (int s = warp; s < count; s += kWarps) {
    const float* As = A + (b0 + s) * n * n;
    for (int i = 0; i < n; ++i) {
      const int row = i * (i + 1) / 2;
      for (int j = lane; j <= i; j += kSystems) {
        L[(row + j) * kStride + s] = As[i * n + j];
      }
    }
    for (int i = lane; i < n; i += kSystems) {
      y[i * kStride + s] = rhs[(b0 + s) * n + i];
    }
  }
  __syncthreads();

  // Left-looking Cholesky, in place: column j of A becomes column j of L.
  // Lanes past `count` run on unstaged shared memory and write nothing out.
  for (int j = 0; j < n; ++j) {
    const int rj = j * (j + 1) / 2;
    // Every warp repeats the diagonal's chain (j terms) rather than wait
    // for one warp to broadcast it.
    float acc = L[(rj + j) * kStride + lane];
    for (int k = 0; k < j; ++k) {
      const float l = L[(rj + k) * kStride + lane];
      acc = sub_mul(acc, l, l);
    }
    // max(acc, 1e-20) with NaN propagated, as jnp.maximum / torch.maximum.
    const float clamped = (acc >= 1e-20f || acc != acc) ? acc : 1e-20f;
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(clamped));
    __syncthreads();   // all warps have read A_jj before warp 0 replaces it
    for (int i = j + 1 + warp; i < n; i += kWarps) {
      const int ri = i * (i + 1) / 2;
      float v = L[(ri + j) * kStride + lane];
      for (int k = 0; k < j; ++k) {
        v = sub_mul(v, L[(ri + k) * kStride + lane],
                    L[(rj + k) * kStride + lane]);
      }
      L[(ri + j) * kStride + lane] = __fmul_rn(v, inv);
    }
    if (warp == 0) L[(rj + j) * kStride + lane] = __fmul_rn(acc, inv);
    __syncthreads();
  }

  if (warp == 0) {
    // Forward substitution  L y = b.
    for (int i = 0; i < n; ++i) {
      const int ri = i * (i + 1) / 2;
      float acc = y[i * kStride + lane];
      for (int k = 0; k < i; ++k) {
        acc = sub_mul(acc, L[(ri + k) * kStride + lane],
                      y[k * kStride + lane]);
      }
      y[i * kStride + lane] = __fdiv_rn(acc, L[(ri + i) * kStride + lane]);
    }
    // Back substitution  L^T x = y, x overwriting y from the end.
    for (int i = n - 1; i >= 0; --i) {
      float acc = y[i * kStride + lane];
      for (int k = i + 1; k < n; ++k) {
        acc = sub_mul(acc, L[(k * (k + 1) / 2 + i) * kStride + lane],
                      y[k * kStride + lane]);
      }
      y[i * kStride + lane] =
          __fdiv_rn(acc, L[(i * (i + 1) / 2 + i) * kStride + lane]);
    }
  }
  __syncthreads();

  for (int s = warp; s < count; s += kWarps) {
    for (int i = lane; i < n; i += kSystems) {
      x[(b0 + s) * n + i] = y[i * kStride + s];
    }
  }
}

}  // namespace

// A: (batch, n, n), b: (batch, n), x: (batch, n); all f32, contiguous, on
// the current device.  Launches on `stream`, allocates nothing, does not
// synchronize.  Returns the first CUDA error met (0 = success).
extern "C" int spd_lanes_solve(const float* A, const float* b, float* x,
                               int n, long long batch, void* stream) {
  if (batch <= 0) return 0;
  const size_t smem = sizeof(float) * kStride *
                      (static_cast<size_t>(n) * (n + 1) / 2 + n);
  cudaError_t err = cudaFuncSetAttribute(
      spd_lanes_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (batch + kSystems - 1) / kSystems;
  spd_lanes_solve_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      A, b, x, n, batch);
  return static_cast<int>(cudaGetLastError());
}
