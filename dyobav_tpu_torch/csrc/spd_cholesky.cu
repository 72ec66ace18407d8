// Batched SPD solve  A d = g  for many small independent f32 systems.
//
// Replaces: dyobav_tpu/ops/pallas_spd.py :: _spd_kernel (the Pallas TPU
// kernel behind `spd_solve`, pallas_call at pallas_spd.py:103).  It
// computes the same thing: an in-place right-looking Cholesky whose pivot
// step scales column j by rsqrt(max(A_jj, 1e-30)) (so the diagonal becomes
// A_jj * rsqrt(...), not sqrt), the rank-1 trailing update of the lower
// triangle, then the forward substitution L y = g and the back
// substitution L^T d = y.  The clamp is kept bit for bit: on an indefinite
// LM rung the pivot clamps instead of producing NaN, as on the TPU.  The
// plain PyTorch version of the same algorithm is `spd_solve_plain` in
// dyobav_tpu_torch/ops/spd.py.  Multiplies and subtracts are issued as
// separate round-to-nearest operations (no FMA contraction) so that the
// kernel does the plain version's arithmetic, operation for operation.
//
// Design: one thread block per system.  The system's contiguous row-major
// n x n matrix (6.4 KB at n = 40) and its right-hand side are read once,
// coalesced, into shared memory with a padded row stride of n + 1 (column
// walks then hit distinct banks), factored and solved there, and the
// solution is written once.  64 threads share each pivot step; at n = 40
// a block holds 6.6 KB of shared memory, so 32 blocks (the per-SM limit,
// 2048 threads) fit on an SM.  The TPU kernel's (8, 128) batch-in-tile
// layout is not carried over.
//
// Bound on an H100 SXM at the main path's warm-stage shape
// (2048 lanes x 4 LM rungs = 8192 systems of n = 40): the solve reads
// only the lower triangle of A, so the bytes that must move are the
// 32-byte sectors holding it (960 floats per system, 31.5 MB in all) + g
// + d (2.6 MB), about 10 us at 3.35 TB/s; the factorization is about
// n^3/6 multiply-adds per system, with the substitutions about 2.1e8 flop,
// about 3 us at the 67 TFLOP/s f32 rate outside the tensor cores.  So the
// kernel is bound by memory.  This kernel loads all of A (52.4 MB); it is
// simple and correct, and staging only the lower triangle with cp.async /
// TMA and several systems per block are later work.
//
// Build (plain C entry point, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libspd_cholesky.so spd_cholesky.cu

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ float sub_mul(float a, float b, float c) {
  return __fsub_rn(a, __fmul_rn(b, c));
}

__global__ void __launch_bounds__(kThreads)
spd_cholesky_solve_kernel(const float* __restrict__ A,
                          const float* __restrict__ g,
                          float* __restrict__ d, int n) {
  extern __shared__ float smem[];
  const int ld = n + 1;
  float* L = smem;            // n rows of stride ld
  float* y = smem + n * ld;   // n
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* Ab = A + b * n * n;
  const float* gb = g + b * n;

  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n;
    L[i * ld + (e - i * n)] = Ab[e];
  }
  for (int i = tid; i < n; i += kThreads) y[i] = gb[i];
  __syncthreads();

  // Right-looking Cholesky, in place in the lower triangle.
  for (int j = 0; j < n; ++j) {
    const float a = L[j * ld + j];
    // max(a, 1e-30) with NaN propagated, as torch.maximum / jnp.maximum.
    const float piv = (a >= 1e-30f || a != a) ? a : 1e-30f;
    const float inv = rsqrtf(piv);
    __syncthreads();  // every thread has read the pivot before it changes
    for (int i = j + tid; i < n; i += kThreads) {
      L[i * ld + j] = __fmul_rn(L[i * ld + j], inv);
    }
    __syncthreads();
    const int m = n - j - 1;
    for (int e = tid; e < m * m; e += kThreads) {
      const int r = e / m;
      const int c = e - r * m;
      if (c <= r) {
        const int i = j + 1 + r;
        const int k = j + 1 + c;
        L[i * ld + k] = sub_mul(L[i * ld + k], L[i * ld + j], L[k * ld + j]);
      }
    }
    __syncthreads();
  }

  // Forward substitution  L y = g.
  for (int j = 0; j < n; ++j) {
    if (tid == 0) y[j] = __fdiv_rn(y[j], L[j * ld + j]);
    __syncthreads();
    const float yj = y[j];
    for (int i = j + 1 + tid; i < n; i += kThreads) {
      y[i] = sub_mul(y[i], L[i * ld + j], yj);
    }
    __syncthreads();
  }

  // Back substitution  L^T d = y.
  for (int j = n - 1; j >= 0; --j) {
    if (tid == 0) y[j] = __fdiv_rn(y[j], L[j * ld + j]);
    __syncthreads();
    const float xj = y[j];
    for (int i = tid; i < j; i += kThreads) {
      y[i] = sub_mul(y[i], L[j * ld + i], xj);
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += kThreads) d[b * n + i] = y[i];
}

}  // namespace

// A: (batch, n, n), g: (batch, n), d: (batch, n); all f32, contiguous, on
// the current device.  Launches on `stream`, allocates nothing, does not
// synchronize.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int spd_cholesky_solve(const float* A, const float* g, float* d,
                                  int n, long long batch, void* stream) {
  if (batch <= 0) return 0;
  const size_t smem = sizeof(float) * (static_cast<size_t>(n) * (n + 1) + n);
  spd_cholesky_solve_kernel<<<static_cast<unsigned int>(batch), kThreads,
                              smem, static_cast<cudaStream_t>(stream)>>>(
      A, g, d, n);
  return static_cast<int>(cudaGetLastError());
}
