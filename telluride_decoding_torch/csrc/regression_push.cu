// Kernel R1: a regression decoder's served call in one launch: the
// prediction, each talker's correlation with it and the scaled LDA.
//
// Replaces no TPU kernel. The JAX package leaves this composition to XLA:
// the prediction is dense layers (telluride_decoding_tpu/models/
// brain_model.py:842 BrainModelDNN._forward, :360 BrainModelLinearRegression)
// and the correlation and reduction are elementwise ops and a small product
// (telluride_decoding_tpu/decode/infer_decoder.py:311 correlate_reduce, :62
// _reduce). The port ran them as cuBLAS float32 products, bias adds, ReLUs
// and seven elementwise kernels a talker, about 23 launches (CUDA graph
// nodes) a served push, whose launches cost some 50 us a push around well
// under a microsecond of work. For a served call this kernel computes
//   pred = relu(... relu(x W0 + b0) ...) W_last + b_last     x [R, F]
//   c_k  = (y_k - mean_x) (pred - mean_y) / power             each talker k
//   s_k  = slope (c_k lda_w) + intercept                      scores [k, R]
// every product in full float32 FMAs on the CUDA cores (no TF32), every sum
// in a fixed order with no float atomics, so that a launch gives the same
// bits each time it runs (eagerly or replayed in a graph). The correlation
// and the LDA round as the plain torch ops do (_rn intrinsics, no
// contraction into FMAs), one operation at a time.
//
// Bound: the work is the first layer, at the codelab's widths 32 x 2553 x
// 20 multiply-adds (3.3 MFLOP), over 0.54 MB of inputs and weights (W0 is
// 204 KB and stays in the 50 MB L2 between pushes; x was written by the lag
// stack just before); by its bytes at 3.35 TB/s a push takes 0.16 us. The
// time is latency: a launch, one round trip to L2, two cluster barriers.
// So the first layer is split over one thread block cluster of up to 16
// blocks, block k owning a contiguous slice of the F inputs:
//   * thread 0 stages the block's slice of W0 [slice, H0p] as one bulk copy
//     (the copy engine, cp.async.bulk, completing on an mbarrier), and the
//     run b0, W1, b1, ..., the statistics and the LDA as another; all
//     threads stage the slice of every row of x with 4-byte cp.async (a
//     row's slice starts at any float, and x's pitch is F floats);
//   * a lane owns a tile of 4 rows by 4 outputs of the first layer and
//     adds every kgroups-th input of the slice; the k-groups' partials are
//     added in group order;
//   * after a cluster barrier each block reads, over distributed shared
//     memory, the 16 slices' partials of its own rows (ceil(R / cluster) of
//     them) and adds them in slice order; then, for those rows alone, the
//     bias, the ReLU, the later layers (a lane an output, its dot product
//     in input order), both talkers' correlations and the LDA, and writes
//     their scores. A last cluster barrier keeps every block alive until
//     the others have read its partials.
// The weights come packed once (ops/regression_push.py::RegressionWeights):
// W0 [F, H0p], then the run b0, W1 [H0p, H1p], b1, ..., mean_x, mean_y,
// power and lda_w [HLp] each, slope, intercept, two zeros; every width
// zero-padded to a multiple of 4 (power padded with ones). Shared memory
// holds the run in the same layout.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace regression {

// Must match ops/regression_push.py (the constants, RegressionPlan,
// smem_bytes).
constexpr int kThreads = 256;
constexpr int kMaxCluster = 16;
constexpr int kMaxRows = 64;
constexpr int kMaxLayers = 4;
constexpr int kMaxWidth = 64;   // A layer's padded width.
constexpr int kMaxOut = 16;     // The prediction's width.
constexpr size_t kMaxSmem = 232448;

struct Plan {
  int rows;        // Rows of the call, every talker's.
  int streams;     // Talkers: 1 or 2.
  int width;       // Inputs of the first layer, F.
  int depth;       // Layers: 1 to kMaxLayers.
  int out;         // The prediction's width (unpadded).
  int ycols;       // Columns of a talker's envelope: 1 or out.
  int cluster;     // Blocks of the one cluster.
  int slice;       // Inputs of a block's slice (the last may hold fewer).
  int run;         // Float offset of the run in the packed weights.
  int run_floats;  // Its floats (a multiple of 4).
  int widths[kMaxLayers];  // Padded output widths of the layers.
};

// Shared memory of one block, in floats, each part 16-byte aligned: the
// slice of W0 [slice][H0p]; the slice of every row of x [rp][pitch] (pitch
// odd, so the rows of a warp's tiles fall on distinct banks); the
// k-groups' partial products [kgroups][rp][H0p]; the run; two buffers of
// the owned rows' activations [owned][widest]; two mbarriers (W0's slice,
// the run).
struct Layout {
  int rp, pitch, tiles, kgroups, owned, widest;
  int x, parts, run, act, bars, total_bytes;
};

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

__host__ __device__ inline int run_floats(const Plan& p) {
  int n = p.widths[0];
  for (int i = 1; i < p.depth; ++i) {
    n += (p.widths[i - 1] + 1) * p.widths[i];
  }
  return n + 4 * p.widths[p.depth - 1] + 4;
}

__host__ __device__ inline Layout layout(const Plan& p) {
  Layout l;
  const int h0 = p.widths[0];
  l.rp = round_up(p.rows, 4);
  l.pitch = p.slice | 1;
  l.tiles = l.rp / 4 * (h0 / 4);
  l.kgroups = kThreads / l.tiles;
  l.owned = (p.rows + p.cluster - 1) / p.cluster;
  l.widest = 0;
  for (int i = 0; i < p.depth; ++i) {
    l.widest = l.widest > p.widths[i] ? l.widest : p.widths[i];
  }
  l.x = p.slice * h0;
  l.parts = l.x + round_up(l.rp * l.pitch, 4);
  l.run = l.parts + l.kgroups * l.rp * h0;
  l.act = l.run + p.run_floats;
  l.bars = l.act + 2 * l.owned * l.widest;
  l.bars += l.bars & 1;  // 8-byte aligned.
  l.total_bytes = (l.bars + 4) * 4;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The two halves of a cluster barrier: arrive (releasing this thread's
// writes to the cluster's shared memory) and wait (acquiring the
// others').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 4 bytes copied asynchronously, in a group that copy_commit closes and
// copy_wait_all waits for.
__device__ __forceinline__ void copy_4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// mbarriers that bulk copies complete on: made once, armed with one
// arrival for the bytes a phase expects, waited on at a phase's parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Copies `bytes` (a multiple of 16) from device memory at src to this
// block's shared memory at dst, both 16-byte aligned, completing on bar.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__global__ void __launch_bounds__(kThreads, 1)
regression_push_kernel(const float* __restrict__ x,
                       const float* __restrict__ ya,
                       const float* __restrict__ yb,
                       const float* __restrict__ weights,
                       float* __restrict__ scores, const Plan plan) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout lay = layout(plan);
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int h0 = plan.widths[0];
  const int rows = plan.rows;
  const int k0 = rank * plan.slice;
  const int klen = max(0, min(plan.slice, plan.width - k0));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  float* ws = smem;
  float* xs = smem + lay.x;
  float* parts = smem + lay.parts;
  const float* run = smem + lay.run;
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bytes = static_cast<uint32_t>(klen) * h0 * 4;
    mbar_expect(bars, bytes);
    if (bytes) {
      bulk_load(ws, weights + static_cast<size_t>(k0) * h0, bytes, bars);
    }
    const uint32_t run_bytes = static_cast<uint32_t>(plan.run_floats) * 4;
    mbar_expect(bars + 1, run_bytes);
    bulk_load(smem + lay.run, weights + plan.run, run_bytes, bars + 1);
  }
  for (int i = tid; i < rows * klen; i += kThreads) {
    const int m = i / klen;
    const int k = i - m * klen;
    copy_4(xs + m * lay.pitch + k,
           x + static_cast<size_t>(m) * plan.width + k0 + k);
  }
  copy_commit();
  copy_wait_all();
  __syncthreads();
  mbar_wait(bars, 0);  // W0's slice is in.

  // The first layer's partial products over this block's slice. Thread
  // (k-group kg, tile (rt, ct)) owns rows rt + {0, 1, 2, 3} rp / 4 and
  // columns 4 ct + {0..3}, and adds inputs kg, kg + kgroups, ... in order.
  const int col_tiles = h0 / 4;
  const int row_tiles = lay.rp / 4;
  const int kg = tid / lay.tiles;
  const int u = tid - kg * lay.tiles;
  const int rt = u / col_tiles;
  const int ct = u - rt * col_tiles;
  if (kg < lay.kgroups) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    const float* xr = xs + rt * lay.pitch;
    const int stride = row_tiles * lay.pitch;
    const float* wc = ws + 4 * ct;
#pragma unroll 4
    for (int k = kg; k < klen; k += lay.kgroups) {
      const float4 w = *reinterpret_cast<const float4*>(wc + k * h0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = xr[i * stride + k];
        acc[i][0] = fmaf(xv, w.x, acc[i][0]);
        acc[i][1] = fmaf(xv, w.y, acc[i][1]);
        acc[i][2] = fmaf(xv, w.z, acc[i][2]);
        acc[i][3] = fmaf(xv, w.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = rt + i * row_tiles;
      *reinterpret_cast<float4*>(parts + (kg * lay.rp + m) * h0 + 4 * ct) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();
  // The k-groups' partials, added in group order into group 0's.
  const int group_stride = lay.rp * h0;
  for (int i = tid; i < rows * col_tiles; i += kThreads) {
    float4* at = reinterpret_cast<float4*>(parts) + i;
    float4 sum = *at;
#pragma unroll 1
    for (int g = 1; g < lay.kgroups; ++g) {
      sum = add4(sum, *reinterpret_cast<const float4*>(
                          parts + g * group_stride + 4 * i));
    }
    *at = sum;
  }
  cluster_arrive();  // This block's partials are written ...
  cluster_wait();    // ... and so are every other block's.

  // This block's rows [first, first + n_own): the slices' partials in
  // slice order, the bias, and the ReLU but after a last layer.
  const int first = rank * lay.owned;
  const int n_own = max(0, min(lay.owned, rows - first));
  float* in = smem + lay.act;
  float* to = in + lay.owned * lay.widest;
  mbar_wait(bars + 1, 0);  // The run is in.
  for (int i = tid; i < n_own * col_tiles; i += kThreads) {
    const int j = i / col_tiles;
    const int c = 4 * (i - j * col_tiles);
    const int at = (first + j) * h0 + c;
    float4 sum = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(parts, 0) + at);
#pragma unroll 1
    for (int s = 1; s < plan.cluster; ++s) {
      sum = add4(sum, *reinterpret_cast<const float4*>(
                          cluster.map_shared_rank(parts, s) + at));
    }
    const float4 b = *reinterpret_cast<const float4*>(run + c);
    float4 v = add4(sum, b);
    if (plan.depth > 1) {
      v = make_float4(relu(v.x), relu(v.y), relu(v.z), relu(v.w));
    }
    *reinterpret_cast<float4*>(in + j * lay.widest + c) = v;
  }
  cluster_arrive();  // This block has read the others' partials.
  __syncthreads();

  // The later layers on the owned rows: a lane an output, its dot product
  // in input order, then the bias, and the ReLU but after the last layer.
  const float* w = run + h0;
  int in_w = h0;
  for (int l = 1; l < plan.depth; ++l) {
    const int out_w = plan.widths[l];
    const float* bias = w + in_w * out_w;
    const bool hidden = l < plan.depth - 1;
    for (int i = tid; i < n_own * out_w; i += kThreads) {
      const int j = i / out_w;
      const int n = i - j * out_w;
      const float* a = in + j * lay.widest;
      float v = 0.f;
#pragma unroll 4
      for (int k = 0; k < in_w; ++k) v = fmaf(a[k], w[k * out_w + n], v);
      v += bias[n];
      to[j * lay.widest + n] = hidden ? relu(v) : v;
    }
    __syncthreads();
    float* done = in;
    in = to;
    to = done;
    w = bias + out_w;
    in_w = out_w;
  }

  // Each talker's correlation with the prediction and the LDA, a lane a
  // (talker, row), as correlate_reduce rounds them.
  const float* mean_x = w;
  const float* mean_y = mean_x + in_w;
  const float* power = mean_y + in_w;
  const float* lda = power + in_w;
  const float slope = lda[in_w];
  const float intercept = lda[in_w + 1];
  for (int i = tid; i < plan.streams * n_own; i += kThreads) {
    const int talker = i / n_own;
    const int j = i - talker * n_own;
    const int r = first + j;
    const float* y = (talker ? yb : ya) + r * plan.ycols;
    const float* p = in + j * lay.widest;
    float d = 0.f;
    for (int o = 0; o < plan.out; ++o) {
      const float yo = y[plan.ycols == 1 ? 0 : o];
      const float c = __fdiv_rn(
          __fmul_rn(__fsub_rn(yo, mean_x[o]), __fsub_rn(p[o], mean_y[o])),
          power[o]);
      d = o == 0 ? __fmul_rn(c, lda[o]) : fmaf(c, lda[o], d);
    }
    scores[talker * rows + r] = __fadd_rn(__fmul_rn(slope, d), intercept);
  }
  cluster_wait();  // No block leaves while another may read its partials.
}

}  // namespace regression

// x [rows, width]; ya and yb [rows, ycols] (yb null for one talker), all
// contiguous float32; weights packed by ops/regression_push.py::
// RegressionWeights; scores [streams, rows]. The kernel's attributes are
// set once per device; a launch the card refuses returns its error.
extern "C" int tdt_regression_push(const float* x, const float* ya,
                                   const float* yb, const float* weights,
                                   float* scores, const regression::Plan* p,
                                   void* stream) {
  using namespace regression;
  bool ok = p->rows >= 1 && p->rows <= kMaxRows && p->streams >= 1 &&
            p->streams <= 2 && (yb != nullptr) == (p->streams == 2) &&
            p->depth >= 1 && p->depth <= kMaxLayers && p->out >= 1 &&
            p->out <= kMaxOut && (p->ycols == 1 || p->ycols == p->out) &&
            p->cluster >= 1 && p->cluster <= kMaxCluster && p->slice >= 1 &&
            p->width >= 1 &&
            static_cast<long long>(p->slice) * p->cluster >= p->width &&
            p->run % 4 == 0;
  for (int i = 0; ok && i < p->depth; ++i) {
    ok = p->widths[i] >= 4 && p->widths[i] <= kMaxWidth &&
         p->widths[i] % 4 == 0;
  }
  ok = ok && p->out <= p->widths[p->depth - 1] &&
       p->run_floats == run_floats(*p) &&
       static_cast<long long>(p->run) >=
           static_cast<long long>(p->width) * p->widths[0];
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(*p);
  const size_t smem = static_cast<size_t>(lay.total_bytes);
  if (lay.tiles > kThreads || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = regression_push_kernel;
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!configured[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(p->cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(p->cluster));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, x, ya, yb, weights, scores, *p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
