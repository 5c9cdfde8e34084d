// Audio envelope + lag stack (K3) for Hopper.
//
// Replaces: telluride_decoding_tpu/ops/fused_frontend.py::
// fused_envelope_lagstack (kernel body _kernel).
//
//   e[m] = (sum_{t1[m] <= j < t2[m]} x[j]^2 / max(t2[m] - t1[m], 1))^(1/2)
//          ^ exponent,  zero for m >= valid_out
//   out[r, k] = e[r + k - pre] where 0 <= r + k - pre < M, else 0,
//   for r in [0, M), k in [0, pre + 1 + post).
//
// The window bounds t1/t2 come from the host, computed in float64 exactly
// as the semantic spec does (fused_frontend.py:46-57): the TPU kernel's
// tile-relative float32 index arithmetic does not carry over.
//
// Bound on this card: the read of the audio. At the ingest shape (6 min
// at 44.1 kHz -> 32 Hz, window 1) each output frame averages ~1378
// samples and the output is 46 KB against 63.5 MB of input. Design: one
// warp per "virtual" frame m in [-pre, M + post). Its lanes stride
// through [t1, t2) with coalesced loads, four independent loads in flight
// per lane, each lane keeping fp32 partial sums of x^2; a butterfly of
// shuffles reduces them. Every output element (r, k) belongs to exactly
// one m = r + k - pre, so the warp then writes its envelope value (zero
// for m outside [0, valid_out)) to all the (r, k) it owns: the zero edges
// come from the virtual frames, no halo is recomputed and there is no
// second pass. There is no prefix sum: a global fp32 cumulative sum
// loses most of the mantissa at the tail of a long recording
// (fused_frontend.py:58-65).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads)
envelope_lagstack_kernel(const float* __restrict__ audio,
                         const int* __restrict__ t1,
                         const int* __restrict__ t2,
                         float* __restrict__ out, int num_out, int valid_out,
                         int pre, int post, float exponent) {
  const long long v =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= static_cast<long long>(num_out) + pre + post) return;
  const int m = static_cast<int>(v) - pre;  // Warp-uniform.
  float e = 0.f;
  if (m >= 0 && m < valid_out) {
    const int begin = t1[m];
    const int end = t2[m];
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int j = begin + lane;
    for (; j + 96 < end; j += 128) {
      const float x0 = audio[j];
      const float x1 = audio[j + 32];
      const float x2 = audio[j + 64];
      const float x3 = audio[j + 96];
      s0 = fmaf(x0, x0, s0);
      s1 = fmaf(x1, x1, s1);
      s2 = fmaf(x2, x2, s2);
      s3 = fmaf(x3, x3, s3);
    }
    for (; j < end; j += 32) {
      const float x0 = audio[j];
      s0 = fmaf(x0, x0, s0);
    }
    float s = (s0 + s1) + (s2 + s3);
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, offset);
    }
    const int count = max(end - begin, 1);
    e = powf(sqrtf(s / static_cast<float>(count)), exponent);
  }
  const int total = pre + 1 + post;
  for (int k = lane; k < total; k += 32) {
    const int r = m - k + pre;
    if (r >= 0 && r < num_out) {
      out[static_cast<long long>(r) * total + k] = e;
    }
  }
}

}  // namespace

extern "C" int tdt_fused_envelope_lagstack(const float* audio, const int* t1,
                                           const int* t2, float* out,
                                           int num_out, int valid_out,
                                           int pre, int post, float exponent,
                                           void* stream) {
  const long long frames = static_cast<long long>(num_out) + pre + post;
  if (num_out == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (frames + kWarps - 1) / kWarps;
  envelope_lagstack_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      audio, t1, t2, out, num_out, valid_out, pre, post, exponent);
  return static_cast<int>(cudaGetLastError());
}
