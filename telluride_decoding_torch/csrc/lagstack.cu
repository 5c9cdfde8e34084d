// Lag stack (K2) for Hopper.
//
// Replaces: telluride_decoding_tpu/ops/lagstack.py::lag_stack_pallas
// (kernel body _lag_stack_kernel).
//
// out[n, k*C + c] = x[n + k - pre, c] where 0 <= n + k - pre < N, else 0,
// for k in [0, pre + 1 + post). Output row n is the contiguous run
// padded[n .. n + pre + post] of the zero-padded input, so in flat terms
// out_flat[n*W + m] = x_flat[n*C + m - pre*C] (W = (pre+1+post)*C), with
// the source index out of [0, N*C) meaning a zero edge.
//
// Bound on this card: the store of the [N, W] output. At codelab width
// (C = 69, 37 lags) every input element is written 37 times, so reads
// come from L1/L2 and the kernel streams one write of the whole output
// to device memory. Design: each thread builds four consecutive output
// elements and writes them with one 16-byte store (the output is a
// fresh allocation, so every 4-aligned flat index is 16-byte aligned);
// the ragged tail falls back to scalar stores. There is no padded copy
// of the input: the edge test is a bounds check on the flat source index.
// A pure copy, so the result is bit-exact.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lag_stack_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long in_elems, long long width, long long total,
                 long long shift, long long channels) {
  const long long first =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (first >= total) return;
  long long row = first / width;
  long long m = first - row * width;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (m == width) {
      m = 0;
      ++row;
    }
    const long long src = row * channels + m - shift;
    v[j] = (first + j < total && src >= 0 && src < in_elems) ? x[src] : 0.f;
    ++m;
  }
  if (first + 4 <= total) {
    *reinterpret_cast<float4*>(out + first) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; first + j < total; ++j) out[first + j] = v[j];
  }
}

}  // namespace

extern "C" int tdt_lag_stack_f32(const float* x, float* out, int n,
                                 int channels, int pre, int post,
                                 void* stream) {
  const long long width = static_cast<long long>(pre + 1 + post) * channels;
  const long long total = width * n;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const long long threads = (total + 3) / 4;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  lag_stack_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x, out, static_cast<long long>(n) * channels, width, total,
      static_cast<long long>(pre) * channels, channels);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
