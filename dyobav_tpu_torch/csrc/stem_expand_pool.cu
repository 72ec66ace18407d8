// The SWTA net's stem expanded over the horizon offsets: for each
// pedestrian p, offset o_k and channel c,
//   z = s[p, c] + o_k * m[c]          (the stem convolution of the image of
//                                      offset o_k: the convolution of the
//                                      shared channels plus o_k times that
//                                      of an all-ones offset channel)
//   y = z * scale[c] + shift[c]       (BatchNorm, eval)
//   y = y > 0 ? y : y * 0.1           (LeakyReLU(0.1))
//   out[p, k, c] = max over each 3 x 3 window of stride 2, padding 1,
//                  out-of-range positions skipped (-inf padding).
//
// Replaces no TPU kernel: the JAX package runs the stem as XLA's
// convolution, BatchNorm, activation and pool on every (pedestrian,
// offset) image.  The port convolves each pedestrian's shared channels once
// and expands over the offsets here, so that the stem's BatchNorm,
// activation and pool, which are not linear and must run for every image,
// read one pedestrian's convolution once and write only the pooled result.
// The plain PyTorch version of the same arithmetic is
// `stem_expand_pool_plain` in dyobav_tpu_torch/ops/stem.py.  Products and
// sums are separate round-to-nearest operations (no FMA contraction) in
// the plain version's order, so the two are bit-equal.
//
// Bound on an H100 SXM at the predictor's shape (P = 64 pedestrians,
// K = 20 offsets, C = 64 channels, 147 x 165 -> 74 x 83): bytes.  s is
// read once (397 MB), m once (6.2 MB), the output written once (2.01 GB):
// about 0.72 ms at 3.35 TB/s.  The instructions are close behind: six an
// activation (o * m, + s, * scale, + shift, * 0.1 and a max), about four
// activations and six maxima of three instructions an output, some 0.7-1.0
// ms at one warp instruction a clock on each of the card's 528
// schedulers.  So the design counts instructions as much as bytes.
//
// Design: a block takes one (p, c) and kTile = 8 output rows, whose pool
// windows span 2 * 8 + 1 input rows.  It copies those rows of s[p, c] and
// of m[c] into shared memory once with cp.async (rows padded to an even
// length, so that a thread reads its two columns with one 8-byte load),
// then loops over the K offsets from there with no further barrier, four
// offsets a pass, which share the shared-memory loads and give each thread
// four independent chains.  Thread j of the block owns output column j:
// for each input row it activates columns 2j and 2j + 1, takes column
// 2j - 1 from its left neighbour with a warp shuffle (lane 0 of each warp
// is a halo thread that computes its column only for that shuffle, so a
// warp writes 31 columns), and keeps the running maximum down the rows in
// a register; every second row completes a window and the thread stores
// it, the warp on 31 neighbouring addresses.  Each input element is thus
// activated once per offset (the halo lanes and the overlap row between
// tiles add 1/31 and 1/16), every byte of s is read from device memory
// once (the overlap row from the L2 cache), m from the L2 cache, and every
// output byte is written once.  The maxima follow max_pool2d's rule and
// order (the first of equal values wins; a NaN wins), so the kernel's
// output equals the plain version's bit for bit.
//
// Build (plain C entry point, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libstem_expand_pool.so stem_expand_pool.cu

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;                  // output rows a block
constexpr int kRows = 2 * kTile + 1;      // input rows of their windows
constexpr int kPass = 4;                  // offsets a pass over the rows
// Threads a block: 31 output columns a warp, Wp <= 512 (Wo <= 1024).
constexpr int kMaxThreads = 32 * ((512 + 30) / 31);
constexpr float kLeaky = 0.1f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

// LeakyReLU(0.1) of z * scale + shift, z = s + o * m.  max(y, y * 0.1) is
// `y > 0 ? y : y * 0.1` for every y but a NaN, which stays a NaN.
__device__ __forceinline__ float activate(float s, float m, float o,
                                          float scale, float shift) {
  const float z = __fadd_rn(s, __fmul_rn(o, m));
  const float y = __fadd_rn(__fmul_rn(z, scale), shift);
  return fmaxf(y, __fmul_rn(y, kLeaky));
}

// max_pool2d's update of a running maximum: `val > max || isnan(val)`.
__device__ __forceinline__ float pick(float best, float v) {
  return (v > best || isnan(v)) ? v : best;
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__global__ void __launch_bounds__(kMaxThreads)
stem_expand_pool_kernel(const float* __restrict__ s,
                        const float* __restrict__ m,
                        const float* __restrict__ offsets,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        float* __restrict__ out, int K, int C, int Ho,
                        int Wo, int Hp, int Wp) {
  extern __shared__ float2 smem[];
  const int half = (Wo + 1) / 2;              // float2s a padded row
  float2* s_tile = smem;                      // kRows x half
  float2* m_tile = s_tile + kRows * half;     // kRows x half

  const int c = blockIdx.y, p = blockIdx.z;
  const int i0 = blockIdx.x * kTile;          // first output row
  const int n_out = min(kTile, Hp - i0);      // output rows of this block
  const int r0 = 2 * i0 - 1;                  // input row of tile row 0
  // Tile rows [t_lo, t_hi) lie inside the image; the others are padding.
  const int t_lo = r0 < 0 ? -r0 : 0;
  const int t_hi = min(kRows, Ho - r0);

  const long long plane = static_cast<long long>(Ho) * Wo;
  const float* s_src = s + (static_cast<long long>(p) * C + c) * plane;
  const float* m_src = m + c * plane;
  float* s_flat = reinterpret_cast<float*>(s_tile);
  float* m_flat = reinterpret_cast<float*>(m_tile);
  for (int t = t_lo; t < t_hi; ++t) {
    const long long row = static_cast<long long>(r0 + t) * Wo;
    for (int x = threadIdx.x; x < Wo; x += blockDim.x) {
      copy_async(s_flat + 2 * half * t + x, s_src + row + x);
      copy_async(m_flat + 2 * half * t + x, m_src + row + x);
    }
  }
  const float sc = scale[c], sh = shift[c];
  const int lane = threadIdx.x & 31;
  const int j = 31 * (threadIdx.x >> 5) + lane - 1;   // output column
  const bool writes = lane > 0 && j < Wp;
  const bool right_ok = j >= 0 && 2 * j + 1 < Wo;     // column 2j + 1
  const int col = min(max(j, 0), half - 1);           // its float2
  const long long out_plane = static_cast<long long>(Hp) * Wp;
  const long long k_stride = C * out_plane;           // offset to offset
  float* dst = out + (static_cast<long long>(p) * K * C + c) * out_plane
               + static_cast<long long>(i0) * Wp + j;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += kPass, dst += kPass * k_stride) {
    float o[kPass], acc[kPass];               // acc: the window's rows so far
#pragma unroll
    for (int q = 0; q < kPass; ++q) o[q] = offsets[min(k0 + q, K - 1)];
    const int n_k = min(kPass, K - k0);       // offsets of this pass
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      float h[kPass];                         // row t's max over 3 columns
      if (t >= t_lo && t < t_hi) {            // the same for the block
        const float2 sv = s_tile[t * half + col];
        const float2 mv = m_tile[t * half + col];
#pragma unroll
        for (int q = 0; q < kPass; ++q) {
          const float a0 = activate(sv.x, mv.x, o[q], sc, sh);
          float a1 = activate(sv.y, mv.y, o[q], sc, sh);
          if (!right_ok) a1 = neg_inf();
          const float left = __shfl_up_sync(kFull, a1, 1);  // column 2j - 1
          h[q] = pick(pick(left, a0), a1);
        }
      } else {
#pragma unroll
        for (int q = 0; q < kPass; ++q) h[q] = neg_inf();
      }
#pragma unroll
      for (int q = 0; q < kPass; ++q) {
        if (t == 0) {
          acc[q] = h[q];
        } else if (t & 1) {
          acc[q] = pick(acc[q], h[q]);
        } else {                              // row t ends window t / 2 - 1
          const int i = t / 2 - 1;
          if (writes && i < n_out && q < n_k)
            dst[q * k_stride + i * Wp] = pick(acc[q], h[q]);
          acc[q] = h[q];
        }
      }
    }
  }
}

int max_smem_set = 48 * 1024;   // the largest dynamic size allowed so far

}  // namespace

// s: (P, C, Ho, Wo), m: (C, Ho, Wo), offsets: (K,), scale and shift: (C,),
// out: (P, K, C, (Ho - 1) / 2 + 1, (Wo - 1) / 2 + 1); all f32, contiguous,
// on the current device; Wo <= 1024, P and C < 65536 (checked in
// ops/stem.py).  Launches on `stream`, allocates nothing, does not
// synchronize.  Returns the first CUDA error met (0 = success).
extern "C" int stem_expand_pool(const float* s, const float* m,
                                const float* offsets, const float* scale,
                                const float* shift, float* out, int P, int K,
                                int C, int Ho, int Wo, void* stream) {
  if (P <= 0 || K <= 0 || C <= 0 || Ho <= 0 || Wo <= 0) return 0;
  const int Hp = (Ho - 1) / 2 + 1, Wp = (Wo - 1) / 2 + 1;
  const int threads = 32 * ((Wp + 30) / 31);  // 31 columns a warp
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float2) * 2 * kRows * ((Wo + 1) / 2);
  if (smem > static_cast<size_t>(max_smem_set)) {
    const cudaError_t err = cudaFuncSetAttribute(
        stem_expand_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    max_smem_set = static_cast<int>(smem);
  }
  const dim3 grid((Hp + kTile - 1) / kTile, C, P);
  stem_expand_pool_kernel<<<grid, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      s, m, offsets, scale, shift, out, K, C, Ho, Wo, Hp, Wp);
  return static_cast<int>(cudaGetLastError());
}
