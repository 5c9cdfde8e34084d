// What chip_smoke.py's s1_bound measures of kernel S1's dependent chain.
// Not part of the port's kernel library: chip_smoke.py builds this file
// on its own (nvcc -shared, sm_90a) and loads it with ctypes.
//
// It includes S1's source, so that the Newton step it times and whose
// SASS it reads is the one S1 runs:
//
//  * s1_newton_step, s1_newton_step_serial: one Newton step as S1 runs
//    it (its two independent quotients as one division on the two
//    half-warps), and the same step with its three IEEE divisions one
//    after another. Straight-line code: z is the kernel's only global
//    load and out its only store, so the chain of dependent instructions
//    from one to the other in the SASS is the chain that links one
//    Newton step to the next.
//  * tdt_s1_latency: SM cycles of one dependent instruction, measured on
//    one warp by clock64 over chains of kChain, each instruction on the
//    result of the one before: out[0] an FP32 add, out[1] MUFU.EX2,
//    out[2] an FP32 add and MUFU.RCP, out[3] expf, out[4] an IEEE
//    division (__fdiv_rn), out[5] S1's Newton step and out[6] the step
//    with serial divisions. ``seed`` is 1; it keeps the compiler from
//    folding the chains. (A chain of shuffles is not timed: nvcc folds
//    a shuffle of a shuffle.)

#include "../telluride_decoding_torch/csrc/ssd_update.cu"

namespace {

constexpr int kChain = 256;

__device__ __forceinline__ float newton_step_serial(float zk, float z_pred,
                                                    float sig_pred,
                                                    float ep_k) {
  const float e = expf(zk);
  const float ope = add(1.f, e);
  return sub(zk, dvd(sub(sub(zk, z_pred),
                         mul(sig_pred, sub(ep_k, dvd(e, ope)))),
                     add(1.f, dvd(mul(sig_pred, e), sq(ope)))));
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm volatile("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int KIND>
__device__ __forceinline__ float chain_step(float x, float seed) {
  switch (KIND) {
    case 0: return add(x, seed);
    case 1: return ex2_approx(-x);
    case 2: return rcp_approx(add(x, seed));
    case 3: return expf(-x);
    case 4: return dvd(1.5f * seed, x);
    case 5: return newton_step(x, 0.1f * seed, 0.5f * seed, 0.6f * seed);
    default:
      return newton_step_serial(x, 0.1f * seed, 0.5f * seed, 0.6f * seed);
  }
}

template <int KIND>
__device__ __forceinline__ void time_chain(float seed, float* out,
                                           float* sink) {
  float x = 0.5f * seed;
  __syncwarp();
  const long long t0 = clock64();
  // Unrolled by 8, so that the loop's own compare and taken branch
  // (about 25 cycles for a lone warp) add an eighth of theirs.
#pragma unroll 8
  for (int i = 0; i < kChain; ++i) x = chain_step<KIND>(x, seed);
  __syncwarp();
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[KIND] = static_cast<float>(t1 - t0) / kChain;
    sink[KIND] = x;
  }
}

__global__ void __launch_bounds__(kLanes)
s1_latency_kernel(float seed, float* out, float* sink) {
  time_chain<0>(seed, out, sink);
  time_chain<1>(seed, out, sink);
  time_chain<2>(seed, out, sink);
  time_chain<3>(seed, out, sink);
  time_chain<4>(seed, out, sink);
  time_chain<5>(seed, out, sink);
  time_chain<6>(seed, out, sink);
}

}  // namespace

extern "C" __global__ void __launch_bounds__(kLanes)
s1_newton_step(const float* z, float* out, float z_pred, float sig_pred,
               float ep_k) {
  out[threadIdx.x] = newton_step(z[threadIdx.x], z_pred, sig_pred, ep_k);
}

extern "C" __global__ void __launch_bounds__(kLanes)
s1_newton_step_serial(const float* z, float* out, float z_pred,
                      float sig_pred, float ep_k) {
  out[threadIdx.x] =
      newton_step_serial(z[threadIdx.x], z_pred, sig_pred, ep_k);
}

// out[0..6] and sink[0..6] on the card.
extern "C" int tdt_s1_latency(float* out, float* sink, void* stream) {
  s1_latency_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      1.f, out, sink);
  return static_cast<int>(cudaGetLastError());
}
