// Batched SPD solve  A d = g  for many small independent f32 systems.
//
// Replaces: dyobav_tpu/ops/pallas_spd.py :: _spd_kernel (the Pallas TPU
// kernel behind `spd_solve`, pallas_call at pallas_spd.py:103).  It
// computes the same thing: an in-place right-looking Cholesky whose pivot
// step scales column j by rsqrt(max(A_jj, 1e-30)) (so the diagonal becomes
// A_jj * rsqrt(...), not sqrt), the rank-1 trailing update of the lower
// triangle, then the forward substitution L y = g and the back
// substitution L^T d = y, both column by column.  The clamp is kept bit
// for bit: on an indefinite LM rung the pivot clamps instead of producing
// NaN, as on the TPU.  The plain PyTorch version of the same algorithm is
// `spd_solve_plain` in dyobav_tpu_torch/ops/spd.py.  Multiplies and
// subtracts are issued as separate round-to-nearest operations (no FMA
// contraction), so element (i, k) receives its updates for j = 0, 1, ...
// in turn with the plain version's roundings, operation for operation.
//
// Design: one warp per system, 8 systems per block, no block barrier.
// Lane l owns rows l, l + 32, l + 64, l + 96 (as many as n needs; the
// kernel is instantiated for 1-4 rows a lane).  The warp copies the lower
// triangle of its row-major system (all the solve reads) with cp.async,
// row by row, neighbouring lanes on neighbouring addresses, into a packed
// row-major triangle in shared memory (row i at i(i+1)/2): for a fixed
// column the rows 0..31 then fall in 32 distinct banks, because the
// triangular numbers mod 32 are a permutation.  The pivots go in panels
// of 8: per pivot j every lane reads the pivot, scales its own rows'
// entries of column j and, after a __syncwarp, updates its own rows'
// entries of the panel's later columns; then one pass over the trailing
// columns k gives each element (i, k) the panel's 8 updates in pivot
// order with one load and one store, reading L_kj as shared-memory
// broadcasts and loading 2 columns ahead of their stores.  The
// substitutions keep y in registers: per step the divisor is a
// broadcast, a shuffle brings y_j (x_j) from its lane, and every lane
// subtracts its own term.  Shared memory per block: 8 n(n+1)/2 floats,
// 26.2 KB at n = 40.
//
// Bound on an H100 SXM at the main path's warm-stage shape
// (2048 lanes x 4 LM rungs = 8192 systems of n = 40): the bytes that must
// move are the 32-byte sectors holding each lower triangle (31.5 MB) + g +
// d (2.6 MB), about 10 us at 3.35 TB/s; the flops are about 3 us at the
// 67 TFLOP/s f32 rate outside the tensor cores.  So the work is bound by
// memory, but the kernel is not: it runs at a small share of that bound,
// waiting on one warp's chain of dependent steps (a shared-memory round
// trip, a reciprocal square root or IEEE division, a shuffle) through n
// pivots and 2n substitution steps.  Below a wave that chain is the
// kernel's time; above it the other warps of an SM stretch it.
// `scripts/profile_torch_spd.py` counts its cycles per phase.
//
// Build (plain C entry point, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libspd_cholesky.so spd_cholesky.cu

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                // systems per block, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kPanel = 8;                // pivots per trailing update
constexpr int kBatch = 2;                // trailing columns per batch
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

// In the loops below a lane computes for each of its rows whether or not
// the row takes part, from addresses inside the warp's triangle (a row
// past n reads row 0), and only its stores are conditional; the loops
// branch on warp-uniform conditions.
template <int kRows>
__global__ void __launch_bounds__(kThreads)
spd_cholesky_solve_kernel(const float* __restrict__ A,
                          const float* __restrict__ g,
                          float* __restrict__ d, int n, long long batch) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long s = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (s >= batch) return;   // the whole warp: the ragged last block
  float* tri = smem + warp * (n * (n + 1) / 2);

  int row[kRows], off[kRows];   // the lane's rows and their packed offsets
  float y[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    row[r] = lane + 32 * r;
    off[r] = row[r] < n ? row[r] * (row[r] + 1) / 2 : 0;
    y[r] = row[r] < n ? g[s * n + row[r]] : 0.0f;
  }
  stage_lower(tri, A + s * n * n, n, lane);

  // Right-looking Cholesky, in place in the packed lower triangle, in
  // panels of kPanel pivots: each pivot scales its column and updates the
  // panel's later columns; then one pass over the trailing columns gives
  // each element the panel's kPanel updates in pivot order, with one load
  // and one store of it.
  int tj = 0;                   // packed offset of row j0
  for (int j0 = 0; j0 < n; j0 += kPanel) {
    float lij[kRows][kPanel];   // the lane's rows' entries of the panel
    int tp = tj;                // packed offset of row j = j0 + p
#pragma unroll
    for (int p = 0; p < kPanel; ++p) {
      const int j = j0 + p;
      if (j < n) {
        const float a = tri[tp + j];
        // max(a, 1e-30) with NaN propagated, as torch.maximum.
        const float piv = (a >= 1e-30f || a != a) ? a : 1e-30f;
        const float inv = rsqrtf(piv);
        __syncwarp();           // every lane has read the pivot
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          lij[r][p] = __fmul_rn(tri[off[r] + j], inv);
          if (row[r] >= j && row[r] < n) tri[off[r] + j] = lij[r][p];
        }
        __syncwarp();           // column j is scaled
        int tk = tp + j + 1;    // packed offset of row k
#pragma unroll
        for (int q = p + 1; q < kPanel; ++q) {
          const int k = j0 + q;
          if (k < n) {
            const float lkj = tri[tk + j];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float v = sub_mul(tri[off[r] + k], lij[r][p], lkj);
              if (row[r] >= k && row[r] < n) tri[off[r] + k] = v;
            }
            tk += k + 1;
          }
        }
        __syncwarp();           // the panel's later columns are updated
        tp += j + 1;
      }
    }
    // The trailing columns k >= j0 + kPanel, kBatch at a time: the loads
    // of a batch (for each slot of rows) before its stores, so that they
    // overlap.
    int tk = tp;                // packed offset of row k
    for (int k = j0 + kPanel; k < n; k += kBatch) {
      float lk[kBatch][kPanel];
      int tku = tk;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int p = 0; p < kPanel; ++p) {
          lk[u][p] = tri[(k + u < n ? tku : tk) + j0 + p];
        }
        tku += k + u + 1;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (32 * r + 31 < k || 32 * r >= n) continue;   // no row of r left
        float e[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          e[u] = tri[off[r] + (k + u < n ? k + u : k)];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
#pragma unroll
          for (int p = 0; p < kPanel; ++p) {
            e[u] = sub_mul(e[u], lij[r][p], lk[u][p]);
          }
          if (row[r] >= k + u && row[r] < n) tri[off[r] + k + u] = e[u];
        }
      }
      tk = tku;
    }
    __syncwarp();               // the trailing triangle is updated
    tj = tp;
  }

  // Forward substitution  L y = g, column by column; column j's y_j is on
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

  // Back substitution  L^T d = y, column by column from the last.
  tj = n * (n - 1) / 2;
#pragma unroll
  for (int rj = kRows - 1; rj >= 0; --rj) {
    for (int jl = 31; jl >= 0; --jl) {
      const int j = 32 * rj + jl;
      if (j >= n) continue;
      const float xj = __fdiv_rn(__shfl_sync(kFull, y[rj], jl), tri[tj + j]);
#pragma unroll
      for (int r = 0; r <= rj; ++r) {
        const float t =
            sub_mul(y[r], tri[tj + (row[r] < j ? row[r] : 0)], xj);
        y[r] = row[r] == j ? xj : (row[r] < j ? t : y[r]);
      }
      tj -= j;
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row[r] < n) d[s * n + row[r]] = y[r];
  }
}

template <int kRows>
int launch(const float* A, const float* g, float* d, int n, long long batch,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * kWarps * (static_cast<size_t>(n) * (n + 1) / 2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spd_cholesky_solve_kernel<kRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (batch + kWarps - 1) / kWarps;
  spd_cholesky_solve_kernel<kRows>
      <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
          A, g, d, n, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A: (batch, n, n), g: (batch, n), d: (batch, n); all f32, contiguous, on
// the current device; 0 < n <= 100 (`MAX_N` in ops/spd.py).  Launches on
// `stream`, allocates nothing, does not synchronize.  Returns the first
// CUDA error met (0 = success).
extern "C" int spd_cholesky_solve(const float* A, const float* g, float* d,
                                  int n, long long batch, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((n + 31) / 32) {
    case 1: return launch<1>(A, g, d, n, batch, st);
    case 2: return launch<2>(A, g, d, n, batch, st);
    case 3: return launch<3>(A, g, d, n, batch, st);
    case 4: return launch<4>(A, g, d, n, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
