// Fused CCA decode (K1) for Hopper.
//
// Replaces: telluride_decoding_tpu/ops/decode_kernel.py::fused_cca_decode
// (kernel body _kernel; parameter folding fold_decode_params; semantics
// fused_cca_decode_reference).
//
// For each window w of x1 [W, T, F1] and x2 [W, T, F2]:
//   r1[t, d] = sum_f x1[w, t, f] * rot1[f, d]     (fp32 accumulation)
//   r2[t, d] = sum_f x2[w, t, f] * rot2[f, d]
//   out[w]   = mean_t sum_d (r1 - c1[d]) * (r2 - c2[d]) * scale[d] + intercept
// With a second x2 stream (the two-speaker pair form) the same x1 rows
// are projected once and scored against both streams.
//
// Bound on this card: reading x1. At codelab width it is 2553 of the
// 2584 input columns, and nothing wider than [W] is written. The
// arithmetic (2 * D flops per x1 element) stays under the fp32 CUDA-core
// rate as long as the rotation operand is not re-read from device memory
// for every row. Design:
//   * each block stages rot1 and rot2, transposed to [D, F] fp32, in
//     dynamic shared memory once (102 KB at F1 = 2553, D = 10), then walks
//     a contiguous range of windows;
//   * a warp takes kRows consecutive rows (frames) at a time; its lanes
//     stride F with coalesced loads of x1, and each lane keeps
//     kRows x D fp32 partial dot products in registers, so one shared-memory
//     read of rot[d, f] feeds kRows fused multiply-adds;
//   * a butterfly warp reduction finishes the dot products, lane 0 scores
//     the rows and adds each score to its window's per-warp partial sum in
//     shared memory; after a barrier the partials are summed in a fixed
//     order, so the result does not depend on scheduling.
// bf16 inputs are widened with __bfloat162float and accumulate in fp32.
// Any W >= 1 and T >= 1 work; D is a template parameter (1..16) so the
// accumulators stay in registers.
// What bounds this simple form in practice is the number of x1 loads in
// flight (one 2-byte load a lane a row, two 8-warp blocks an SM), not
// the bandwidth: staging x1 rows through shared memory with wide
// asynchronous copies is the next step (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Projects rows row0 .. row0 + kRows - 1 of x [*, f] onto rot_t [D, f]
// (shared memory). Rows at or past last_row re-read last_row, so every
// load stays in bounds; the caller ignores their results. On return every
// lane holds the full sums.
template <typename T, int D>
__device__ __forceinline__ void project_rows(const T* __restrict__ x,
                                             long long row0,
                                             long long last_row, int f,
                                             const float* rot_t, int lane,
                                             float (&acc)[kRows][D]) {
  const T* rows[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = row0 + r < last_row ? row0 + r : last_row;
    rows[r] = x + row * f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[r][d] = 0.f;
  }
#pragma unroll 2
  for (int j = lane; j < f; j += 32) {
    float xv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) xv[r] = to_float(rows[r][j]);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float rv = rot_t[d * f + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][d] = fmaf(xv[r], rv, acc[r][d]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
        acc[r][d] += __shfl_xor_sync(0xffffffffu, acc[r][d], offset);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ float score_row(const float (&r1)[D],
                                           const float (&r2)[D],
                                           const float* consts) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    s += (r1[d] - consts[d]) * (r2[d] - consts[D + d]) * consts[2 * D + d];
  }
  return s;
}

// Two blocks per SM (at most 128 registers a thread, no spills at D = 10)
// keep twice the loads of x1 in flight of one block per SM.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
fused_cca_decode_kernel(const T* __restrict__ x1, const T* __restrict__ x2a,
                        const T* __restrict__ x2b,
                        const float* __restrict__ rot1_t,
                        const float* __restrict__ rot2_t,
                        const float* __restrict__ consts_in,
                        float* __restrict__ out_a, float* __restrict__ out_b,
                        int windows, int frames, int f1, int f2,
                        int windows_per_block) {
  extern __shared__ float smem[];
  float* consts = smem;                    // c1 [D], c2 [D], scale [D], intercept
  float* s_rot1 = consts + 3 * D + 1;      // [D, f1]
  float* s_rot2 = s_rot1 + D * f1;         // [D, f2]
  float* part_a = s_rot2 + D * f2;         // [kWarps, windows_per_block]
  float* part_b = part_a + kWarps * windows_per_block;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < 3 * D + 1; i += kThreads) consts[i] = consts_in[i];
  for (int i = tid; i < D * f1; i += kThreads) s_rot1[i] = rot1_t[i];
  for (int i = tid; i < D * f2; i += kThreads) s_rot2[i] = rot2_t[i];
  for (int i = tid; i < 2 * kWarps * windows_per_block; i += kThreads) {
    part_a[i] = 0.f;
  }
  __syncthreads();

  const int w0 = blockIdx.x * windows_per_block;
  const int nw = min(windows_per_block, windows - w0);
  const long long row_begin = static_cast<long long>(w0) * frames;
  const long long row_end = row_begin + static_cast<long long>(nw) * frames;
  const bool pair = x2b != nullptr;
  float* my_part_a = part_a + warp * windows_per_block;
  float* my_part_b = part_b + warp * windows_per_block;

  for (long long row0 = row_begin + warp * kRows; row0 < row_end;
       row0 += kWarps * kRows) {
    float r1[kRows][D];
    float r2[kRows][D];
    project_rows<T, D>(x1, row0, row_end - 1, f1, s_rot1, lane, r1);
    project_rows<T, D>(x2a, row0, row_end - 1, f2, s_rot2, lane, r2);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (row0 + r < row_end) {
          my_part_a[(row0 + r) / frames - w0] += score_row<D>(r1[r], r2[r], consts);
        }
      }
    }
    if (pair) {
      project_rows<T, D>(x2b, row0, row_end - 1, f2, s_rot2, lane, r2);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (row0 + r < row_end) {
            my_part_b[(row0 + r) / frames - w0] += score_row<D>(r1[r], r2[r], consts);
          }
        }
      }
    }
  }
  __syncthreads();

  const float intercept = consts[3 * D];
  const float inv_frames = 1.f / static_cast<float>(frames);
  for (int j = tid; j < nw; j += kThreads) {
    float sa = 0.f;
    float sb = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      sa += part_a[k * windows_per_block + j];
      sb += part_b[k * windows_per_block + j];
    }
    out_a[w0 + j] = sa * inv_frames + intercept;
    if (pair) out_b[w0 + j] = sb * inv_frames + intercept;
  }
}

template <typename T, int D>
cudaError_t launch(const void* x1, const void* x2a, const void* x2b,
                   const float* rot1_t, const float* rot2_t,
                   const float* consts, float* out_a, float* out_b,
                   int windows, int frames, int f1, int f2,
                   int windows_per_block, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (3 * D + 1 + static_cast<size_t>(D) * (f1 + f2) +
       2 * kWarps * static_cast<size_t>(windows_per_block));
  auto kernel = fused_cca_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (windows + windows_per_block - 1) / windows_per_block;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2a),
      static_cast<const T*>(x2b), rot1_t, rot2_t, consts, out_a, out_b,
      windows, frames, f1, f2, windows_per_block);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dims(int d, const void* x1, const void* x2a,
                          const void* x2b, const float* rot1_t,
                          const float* rot2_t, const float* consts,
                          float* out_a, float* out_b, int windows, int frames,
                          int f1, int f2, int windows_per_block,
                          cudaStream_t stream) {
  switch (d) {
#define TDT_DIMS_CASE(N)                                                   \
  case N:                                                                  \
    return launch<T, N>(x1, x2a, x2b, rot1_t, rot2_t, consts, out_a, out_b, \
                        windows, frames, f1, f2, windows_per_block, stream);
    TDT_DIMS_CASE(1) TDT_DIMS_CASE(2) TDT_DIMS_CASE(3) TDT_DIMS_CASE(4)
    TDT_DIMS_CASE(5) TDT_DIMS_CASE(6) TDT_DIMS_CASE(7) TDT_DIMS_CASE(8)
    TDT_DIMS_CASE(9) TDT_DIMS_CASE(10) TDT_DIMS_CASE(11) TDT_DIMS_CASE(12)
    TDT_DIMS_CASE(13) TDT_DIMS_CASE(14) TDT_DIMS_CASE(15) TDT_DIMS_CASE(16)
#undef TDT_DIMS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x1, x2a and x2b share it). x2b and
// out_b are null for the single-stream form. consts holds c1 [d], c2 [d],
// scale [d] and the intercept, fp32; rot1_t [d, f1] and rot2_t [d, f2] are
// fp32, already rounded to the inputs' dtype by the caller.
extern "C" int tdt_fused_cca_decode(const void* x1, const void* x2a,
                                    const void* x2b, const float* rot1_t,
                                    const float* rot2_t, const float* consts,
                                    float* out_a, float* out_b, int windows,
                                    int frames, int f1, int f2, int d,
                                    int dtype, int windows_per_block,
                                    void* stream) {
  if (windows <= 0 || frames <= 0 || windows_per_block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_dims<float>(d, x1, x2a, x2b, rot1_t, rot2_t, consts, out_a,
                               out_b, windows, frames, f1, f2,
                               windows_per_block, s);
  } else if (dtype == 1) {
    err = dispatch_dims<__nv_bfloat16>(d, x1, x2a, x2b, rot1_t, rot2_t, consts,
                                       out_a, out_b, windows, frames, f1, f2,
                                       windows_per_block, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
