// Batched SPD solve  A x = b  by a left-looking Cholesky, one system per
// warp.
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
// Design: one warp per system, rows on lanes, 8 systems per block, no
// block barrier.  Lane l owns rows l, l + 32, l + 64, l + 96 (as many as n
// needs; the kernel is instantiated for 1-4 rows a lane).  The warp copies
// the lower triangle of its row-major system with cp.async, row by row,
// neighbouring lanes on neighbouring addresses, into a packed row-major
// triangle in shared memory (row i at i(i+1)/2; for a fixed column the
// rows 0..31 fall in 32 distinct banks, the triangular numbers mod 32
// being a permutation).  Columns go in panels of 4: every lane with a row
// i >= j0 runs its own dot products against rows j0..j0+3 for the terms
// k < j0, loading each of its L_ik once for the 4 columns while rows
// j0..j0+3's entries are shared-memory broadcasts; then each column takes
// its terms from the panel's earlier columns, so every sum keeps its
// ascending k.  The diagonal's acc is shuffled from lane j % 32 to all
// lanes (computed once, not once per warp), and one __syncwarp a column
// orders the writes.  The forward substitution is lane-parallel in column
// form (y in registers, y_j shuffled).  The back substitution keeps its
// ascending sums, so its chain is serial: per row the lanes write their
// products L_ki x_k to shared memory at once, in order of k, and every
// lane subtracts them, read four at a time as broadcasts.  Shared memory
// per block: 8 (n(n+1)/2 + n + 4) floats rounded to 16 bytes, 27.6 KB at
// n = 40.  The TPU kernel's (n, n, 128) transposed blocks and its padding
// with identity systems are not carried over: the warps past the batch in
// the ragged last block return at once.
//
// Bound on an H100 SXM at (8192, 40, 40): the bytes that must move are the
// 32-byte sectors holding each lower triangle (31.5 MB) + b + x (2.6 MB),
// about 10 us at 3.35 TB/s; the about 2.1e8 flops take about 3 us at the
// 67 TFLOP/s f32 rate outside the tensor cores.  So the work is bound by
// memory, but the kernel is not: it runs at a small share of that bound,
// waiting on one warp's chain of dependent steps (a shared-memory round
// trip, an IEEE square root or division, a shuffle; n per column and a
// serial chain of n(n-1)/2 subtractions in the back substitution).  Below
// a wave that chain is the kernel's time; above it the other warps of an
// SM stretch it.  `scripts/profile_torch_spd.py` counts its cycles per
// phase.
//
// Build (plain C entry point, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libspd_lanes.so spd_lanes.cu

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                // systems per block, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kPanel = 4;                // columns per pass over a row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sub_mul(float a, float b, float c) {
  return __fsub_rn(a, __fmul_rn(b, c));
}

// Copies the lower triangle of the row-major n x n matrix `A` (n <= 128)
// into the packed row-major triangle `tri` with 4-byte cp.async copies (no
// register staging), row by row with lane c on column c, then waits for
// them and syncs the warp.
__device__ __forceinline__ void stage_lower(float* tri, const float* A,
                                            int n, int lane) {
  int ti = 0;
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int c0 = 0; c0 < 128; c0 += 32) {
      const int c = c0 + lane;
      if (c0 <= i && c <= i) {
        const unsigned dst =
            static_cast<unsigned>(__cvta_generic_to_shared(tri + ti + c));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(dst), "l"(A + i * n + c) : "memory");
      }
    }
    ti += i + 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

__host__ __device__ __forceinline__ int round4(int m) { return (m + 3) & ~3; }

// Floats of a warp's shared memory: the packed triangle, then the back
// substitution's products and a dummy slot, each from a 16-byte boundary.
__host__ __device__ __forceinline__ int warp_floats(int n) {
  return round4(n * (n + 1) / 2) + round4(n) + 4;
}

// In the loops below a lane computes for each of its rows whether or not
// the row takes part, from addresses inside the warp's triangle (a row
// past n reads row 0), and a row that does not take part stores to a
// dummy slot: the code has no branch that splits the warp, and its
// branches are on warp-uniform conditions.
template <int kRows>
__global__ void __launch_bounds__(kThreads)
spd_lanes_solve_kernel(const float* __restrict__ A,
                       const float* __restrict__ rhs,
                       float* __restrict__ x, int n, long long batch) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long s = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (s >= batch) return;   // the whole warp: the ragged last block
  float* tri = reinterpret_cast<float*>(smem4) + warp * warp_floats(n);
  float* ps = tri + round4(n * (n + 1) / 2);   // the products
  const int dummy = round4(n) + 3;             // ps[dummy]: read by no one
  const int tri_dummy = round4(n * (n + 1) / 2) + dummy;
  for (int m = lane; m < round4(n) + 4; m += 32) ps[m] = 0.0f;

  int row[kRows], off[kRows];   // the lane's rows and their packed offsets
  float y[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    row[r] = lane + 32 * r;
    off[r] = row[r] < n ? row[r] * (row[r] + 1) / 2 : 0;
    y[r] = row[r] < n ? rhs[s * n + row[r]] : 0.0f;
  }
  stage_lower(tri, A + s * n * n, n, lane);

  // Left-looking Cholesky, in place: column j of A becomes column j of L,
  // kPanel columns at a time.  Row i's sums for the panel's columns take
  // their terms k < j0 in one pass, each L_ik loaded once for the kPanel
  // columns; then each column in turn takes its terms from the panel's
  // earlier columns, so every sum still runs in ascending k.  Panels never
  // straddle a multiple of 32, so row j's sum sits in the constant slot rj.
  int tj = 0;                   // packed offset of row j0
#pragma unroll
  for (int rj = 0; rj < kRows; ++rj) {
    for (int j0 = 32 * rj; j0 < n && j0 < 32 * rj + 32; j0 += kPanel) {
      int tq[kPanel];           // packed offsets of rows j0 + q
      tq[0] = tj;
#pragma unroll
      for (int q = 1; q < kPanel; ++q) tq[q] = tq[q - 1] + j0 + q;
      float acc[kRows][kPanel];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int q = 0; q < kPanel; ++q) {
          acc[r][q] = tri[off[r] + (j0 + q < n ? j0 + q : j0)];
        }
      }
#pragma unroll 4
      for (int k = 0; k < j0; ++k) {
        float ljk[kPanel];
#pragma unroll
        for (int q = 0; q < kPanel; ++q) {
          ljk[q] = tri[(j0 + q < n ? tq[q] : tq[0]) + k];
        }
#pragma unroll
        for (int r = rj; r < kRows; ++r) {
          const float lik = tri[off[r] + k];
#pragma unroll
          for (int q = 0; q < kPanel; ++q) {
            acc[r][q] = sub_mul(acc[r][q], lik, ljk[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kPanel; ++q) {
        const int j = j0 + q;
        if (j < n) {
#pragma unroll
          for (int p = 0; p < q; ++p) {
            const float ljk = tri[tq[q] + j0 + p];
#pragma unroll
            for (int r = rj; r < kRows; ++r) {
              acc[r][q] = sub_mul(acc[r][q], tri[off[r] + j0 + p], ljk);
            }
          }
          const float diag = __shfl_sync(kFull, acc[rj][q], j & 31);
          // max(acc, 1e-20) with NaN propagated, as jnp.maximum.
          const float clamped =
              (diag >= 1e-20f || diag != diag) ? diag : 1e-20f;
          const float inv = __fdiv_rn(1.0f, __fsqrt_rn(clamped));
#pragma unroll
          for (int r = rj; r < kRows; ++r) {
            tri[row[r] >= j && row[r] < n ? off[r] + j : tri_dummy] =
                __fmul_rn(acc[r][q], inv);
          }
          __syncwarp();         // column j is written
        }
      }
      tj = tq[kPanel - 1] + j0 + kPanel;
    }
  }

  // Forward substitution  L y = b, column by column: row i subtracts its
  // terms in ascending k, as the row-wise sum does.  Column j's y_j is on
  // lane j % 32 in slot j / 32 (a constant in each unrolled pass).
  tj = 0;
#pragma unroll
  for (int rj = 0; rj < kRows; ++rj) {
    for (int jl = 0; jl < 32; ++jl) {
      const int j = 32 * rj + jl;
      if (j >= n) break;
      const float yj = __fdiv_rn(__shfl_sync(kFull, y[rj], jl), tri[tj + j]);
#pragma unroll
      for (int r = rj; r < kRows; ++r) {
        const float t = sub_mul(y[r], tri[off[r] + j], yj);
        y[r] = row[r] == j ? yj : (row[r] > j ? t : y[r]);
      }
      tj += j + 1;
    }
  }

  // Back substitution  L^T x = y.  x_i needs every x_k, k > i, and its sum
  // runs in ascending k, so the chain is serial: per row the lanes write
  // their rows' products L_ki x_k, in order of k, from the start of `ps`,
  // and every lane subtracts them, read four at a time as broadcasts.  The
  // slots past the last product have held +0 since the start (each row
  // writes fewer than the one before), and x - (+0) = x exactly.
  tj = n * (n - 1) / 2;
#pragma unroll
  for (int ri = kRows - 1; ri >= 0; --ri) {
    for (int il = 31; il >= 0; --il) {
      const int i = 32 * ri + il;
      if (i >= n) continue;
#pragma unroll
      for (int r = ri; r < kRows; ++r) {
        const float pr = __fmul_rn(tri[off[r] + i], y[r]);
        ps[row[r] > i && row[r] < n ? row[r] - i - 1 : dummy] = pr;
      }
      __syncwarp();             // the products are written
      float a = __shfl_sync(kFull, y[ri], il);
#pragma unroll 4
      for (int m = 0; m < n - 1 - i; m += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + m);
        a = __fsub_rn(__fsub_rn(__fsub_rn(__fsub_rn(a, p4.x), p4.y), p4.z),
                      p4.w);
      }
      const float xi = __fdiv_rn(a, tri[tj + i]);
      y[ri] = lane == il ? xi : y[ri];
      __syncwarp();             // the products are read
      tj -= i;
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row[r] < n) x[s * n + row[r]] = y[r];
  }
}

template <int kRows>
int launch(const float* A, const float* b, float* x, int n, long long batch,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * warp_floats(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spd_lanes_solve_kernel<kRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (batch + kWarps - 1) / kWarps;
  spd_lanes_solve_kernel<kRows>
      <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
          A, b, x, n, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A: (batch, n, n), b: (batch, n), x: (batch, n); all f32, contiguous, on
// the current device; 0 < n <= 100 (`MAX_N` in ops/spd_lanes.py).
// Launches on `stream`, allocates nothing, does not synchronize.  Returns
// the first CUDA error met (0 = success).
extern "C" int spd_lanes_solve(const float* A, const float* b, float* x,
                               int n, long long batch, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((n + 31) / 32) {
    case 1: return launch<1>(A, b, x, n, batch, st);
    case 2: return launch<2>(A, b, x, n, batch, st);
    case 3: return launch<3>(A, b, x, n, batch, st);
    case 4: return launch<4>(A, b, x, n, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
