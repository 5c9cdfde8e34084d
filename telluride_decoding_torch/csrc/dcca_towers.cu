// Kernel T1: both towers of a deep CCA decoder on one served chunk, in one
// launch.
//
// Replaces no TPU kernel. The JAX package's towers (telluride_decoding_tpu/
// models/cca.py:198, BrainModelDCCA._tower through _apply_mlp) are XLA
// dense layers; the port ran them as cuBLAS float32 products, bias adds and
// ReLUs, about 25 launches (CUDA graph nodes) a served push, whose launches
// and chain cost some 70 us a push around half a microsecond of work. For a
// served pair this kernel computes
//   h1 = tower1(x1)                  x1 [R, F1]
//   h2 = tower2([x2a; x2b])          [S R, F2], S = 1 or 2 streams
// with tower(x) = relu(... relu(x W0 + b0) W1 + b1 ...) W_last + b_last,
// every product in full float32 FMAs on the CUDA cores (no TF32), every sum
// in a fixed order with no float atomics, so that a launch gives the same
// bits each time it runs (eagerly or replayed in a graph).
//
// Bound: the work is tower 1's first layer at the codelab's widths, 32 x
// 2553 x 128 multiply-adds (20.9 MFLOP), over 1.31 MB of weights that stay
// in the 50 MB L2 between pushes; by its bytes at 3.35 TB/s a served push's
// towers take 0.54 us. One SM can neither stream 1.3 MB nor do 21 MFLOP in
// a few microseconds, so the first layer is split over thread block
// clusters of 16 (blockIdx.y picks the cluster):
//   * a tower's first-layer inputs are split among ks blocks of a cluster
//     in contiguous slices, its rows among 16 / ks row groups; wide inputs
//     of the EEG tower span 2 or 4 clusters. At the codelab's widths the
//     EEG tower takes 4 clusters of 16 slices of 40 inputs, the audio
//     tower (31 inputs) one cluster, ks = 1, 16 groups of 4 rows;
//   * a block stages its whole slice of W0 at once, in up to eight chunks
//     in flight together, each one bulk copy (the copy engine,
//     cp.async.bulk, completing on a slot's mbarrier) that one thread
//     issues: from L2 a copy takes about a microsecond, so the bytes in
//     flight set the rate, and 16-byte copies from every thread would
//     stall the threads that should multiply. The slice of its group's
//     rows of x, whose pitch is not a multiple of 16 bytes, comes once as
//     the 16-byte granules that hold each row (16-byte cp.async from all
//     threads), its offset in the first one kept;
//   * it multiplies with FP32 FFMA as the chunks land. Shared memory
//     bandwidth, not the FMA pipes, bounds a SIMT product of this shape:
//     a lane owns an 8 x 8 tile (per four inputs, 32 words of x and 8
//     float4s of W0 feed 256 FMAs) and the block's warps split each chunk's
//     inputs among k-groups, each covering the whole [rows, H0] output,
//     whose partials are then added in group order;
//   * the block sends its partial products of each owner's rows into the
//     shared memory of the block that owns them, one bulk copy (the copy
//     engine, cp.async.bulk between shared memories) an owner, into a slot
//     a slice, completing on the owner's mbarrier: one block's rows are
//     contiguous, and the copy engine moves them far faster than stores of
//     16 bytes. Each block then adds, for its share of its group's rows,
//     the ks partials in slice order;
//   * across clusters the blocks that own the same rows meet in device
//     memory: each leaves its cluster's sums there and counts its arrival
//     (an integer atomic), and the last to arrive adds the clusters' sums
//     in cluster order and goes on alone; the count is left at zero for
//     the next launch. Launches that share the weights run one after
//     another on one stream;
//   * then the bias, the ReLU, and the later layers on the owned rows in
//     shared memory (their weights were copied in behind the last chunk; a
//     few lanes share each output's dot product), writing only the
//     tower's output. A last cluster barrier keeps every block alive
//     until the copies out of its shared memory have landed.
// Code run once a launch is fetched from the instruction cache as it runs,
// at several cycles an instruction, so the one-time parts (staging, the
// exchange, the later layers) are loops written once, not unrolled.
// The weights come packed once (ops/dcca_towers.py::TowerWeights): per
// tower, W0 [F, H0p], then b0 and each later layer's [in, out] and bias in
// one run, every width zero-padded (H0p to a multiple of 32, the others to
// 4); shared memory holds that run in the same layout.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace towers {

// Must match ops/dcca_towers.py (the constants, TowerPlan, smem_bytes).
constexpr int kThreads = 256;
constexpr int kMaxCluster = 16;
constexpr int kStages = 8;      // Chunks in flight.
constexpr int kMaxChunk = 64;   // Inputs a chunk.
constexpr int kTile = 8;        // A lane's tile of the first layer: 8 x 8.
constexpr int kMaxLayers = 3;
constexpr int kMaxRows = 64;    // Rows a stream.
constexpr int kMaxWidth = 256;  // Padded width of a layer's output.
constexpr int kMaxSplit = 8;    // Lanes sharing a later layer's output.
constexpr size_t kMaxSmem = 232448;

struct Tower {
  int width;       // Inputs of the first layer.
  int streams;     // Input streams stacked as rows (1, or 2 for tower 2).
  int clusters;    // Clusters the first layer's inputs are split among.
  int kslices;     // Blocks of a cluster they are split among.
  int slice;       // Inputs a slice.
  int chunk;       // Inputs a chunk.
  int group_rows;  // Rows of a row group.
  int w0;          // Float offsets in the packed weights of W0 and of the
  int later;       // run b0, W1, b1, ... (multiples of 4).
};

struct Plan {
  int rows;     // Rows a stream.
  int depth;    // Layers a tower: 2 or 3.
  int dims;     // The last layer's width.
  int cluster;  // Blocks a cluster.
  int widths[kMaxLayers];  // Padded output widths of the layers.
  Tower tower[2];
};

// Shared memory of one block, in floats, each part 16-byte aligned: the
// ring of up to kStages chunks of W0's rows [kpad][H0p] (zero past the
// slice's last input to its quad's end), which the k-groups' partial
// products [kgroups][mp][H0p] overwrite once the last chunk is done; the
// group's rows of the slice [mp][pitch], as copied granules; the partial
// products of the owned rows that the ks blocks of the group send here
// [ks][owned][H0p]; the run b0, W1, b1, ...; two buffers of the owned
// rows' activations; the mbarriers: one a slot, one for the run, one the
// partials complete on; the count of clusters that arrived before.
struct Layout {
  int mp, kpad, pitch, owned, widest, tpg, kgroups, slots;
  int stage, x, recv, later, later_floats, act, bars, total_bytes;
};

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

__host__ __device__ inline Layout layout(const Plan& p, const Tower& t) {
  Layout l;
  const int h0 = p.widths[0];
  l.mp = round_up(t.group_rows, kTile);
  l.kpad = round_up(t.chunk, 4);
  // A row's granules, and rows 4 apart on other banks.
  l.pitch = round_up(t.slice + 3, 8) + 4;
  l.owned = (t.group_rows + t.kslices - 1) / t.kslices;
  l.tpg = l.mp / kTile * (h0 / kTile);
  l.kgroups = kThreads / l.tpg;
  l.slots = (t.slice + t.chunk - 1) / t.chunk;
  l.slots = l.slots < kStages ? l.slots : kStages;
  l.stage = l.kpad * h0;
  const int ring = l.slots * l.stage;
  const int parts = l.kgroups * l.mp * h0;
  l.x = ring > parts ? ring : parts;
  l.recv = l.x + l.mp * l.pitch;
  l.later = l.recv + t.kslices * l.owned * h0;
  l.later_floats = h0;
  l.widest = h0;
  for (int i = 1; i < p.depth; ++i) {
    l.later_floats += (p.widths[i - 1] + 1) * p.widths[i];
    l.widest = l.widest > p.widths[i] ? l.widest : p.widths[i];
  }
  l.act = l.later + l.later_floats;
  l.bars = l.act + 2 * l.owned * l.widest;
  l.bars += l.bars & 1;  // 8-byte aligned.
  l.total_bytes = (l.bars + 2 * (kStages + 3)) * 4;
  return l;
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes copied asynchronously between 16-byte aligned addresses, in a
// group that copy_commit closes and copy_wait_all waits for.
__device__ __forceinline__ void copy_16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// mbarriers that bulk copies complete on: made once (visible to the
// cluster after the next release), armed with one arrival for the bytes a
// phase expects, waited on at a phase's parity.
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

// Copies `bytes` (a multiple of 16) of this block's shared memory at src
// to the same offsets as dst in the shared memory of block `rank` of the
// cluster, completing on that block's mbarrier at bar's offset.
__device__ __forceinline__ void bulk_send(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar,
                                          int rank) {
  uint32_t remote_dst, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_dst) : "r"(smem_addr(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_bar) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(remote_dst), "r"(smem_addr(src)), "r"(bytes), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// Tower `second` of the plan, field by field (an index into the kernel's
// parameters would copy them to local memory).
__device__ __forceinline__ Tower pick(const Plan& p, bool second) {
  const Tower& a = p.tower[0];
  const Tower& b = p.tower[1];
  Tower t;
  t.width = second ? b.width : a.width;
  t.streams = second ? b.streams : a.streams;
  t.clusters = second ? b.clusters : a.clusters;
  t.kslices = second ? b.kslices : a.kslices;
  t.slice = second ? b.slice : a.slice;
  t.chunk = second ? b.chunk : a.chunk;
  t.group_rows = second ? b.group_rows : a.group_rows;
  t.w0 = second ? b.w0 : a.w0;
  t.later = second ? b.later : a.later;
  return t;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__global__ void __launch_bounds__(kThreads, 1)
dcca_towers_kernel(const float* __restrict__ x1, const float* __restrict__ x2a,
                   const float* __restrict__ x2b,
                   const float* __restrict__ weights, float* __restrict__ h1,
                   float* __restrict__ h2, float* __restrict__ scratch,
                   int* __restrict__ arrivals, const Plan plan) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // Clusters 0 .. c - 1 take tower 1's slices, cluster c tower 2's.
  const bool audio = blockIdx.y == plan.tower[0].clusters;
  const int part = audio ? 0 : blockIdx.y;
  const Tower t = pick(plan, audio);
  const Layout lay = layout(plan, t);
  const int tid = threadIdx.x;
  // A slot's mbarrier, the run's, the partials'.
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* later_bar = bars + kStages;
  uint64_t* bar = later_bar + 1;
  int* arrived = reinterpret_cast<int*>(bar + 1);
  if (tid == 0) {
    for (int i = 0; i < kStages + 2; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();  // This block has started; its mbarriers are made.
  const int rank = static_cast<int>(cluster.block_rank());
  const int h0 = plan.widths[0];
  const int ks = t.kslices;
  const int kq = rank % ks;        // This block's slice of the inputs.
  const int group = rank / ks;     // Its row group.
  const int rows = plan.rows;
  const int g0 = group * t.group_rows;
  const int g_rows = max(0, min(t.group_rows, t.streams * rows - g0));
  const int k0 = (part * ks + kq) * t.slice;
  const int klen = max(0, min(t.slice, t.width - k0));
  const int chunk = t.chunk;
  const int chunks = (klen + chunk - 1) / chunk;
  const float* xa = audio ? x2a : x1;
  const float* xb = audio ? x2b : x1;
  float* out = audio ? h2 : h1;
  // Group row m's input kc, and where its chunk starting at kc lies in
  // its first granule (in words).
  auto input = [&](int m, int kc) {
    const int row = g0 + m;
    return (row < rows ? xa + row * t.width : xb + (row - rows) * t.width) +
           kc;
  };
  auto offset = [](const float* p) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(p) >> 2 & 3);
  };

  // The first layer's partial products over this block's slice. Thread
  // (k-group kg, tile u = (rt, ct)) owns rows 4 rt + {0..3} and mp / 2 +
  // 4 rt + {0..3}, columns 4 ct + {0..3} and H0p / 2 + 4 ct + {0..3}, and
  // adds the terms of each chunk's input quads q = kg mod kgroups in input
  // order.
  const int kg = tid / lay.tpg;
  const int u = tid - kg * lay.tpg;
  const int r0 = 4 * (u / (h0 / kTile));
  const int c0 = 4 * (u % (h0 / kTile));
  const int half_rows = lay.mp / 2;
  const int half_cols = h0 / 2;
  const bool active = kg < lay.kgroups;
  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.f;
  }
  // Thread 0 stages chunk c of W0's rows into slot c % slots (one copy,
  // completing on the slot's mbarrier); the run b0, W1, ... after the last
  // chunk.
  auto stage = [&](int c) {
    const int slot = c % lay.slots;
    const int kc = k0 + c * chunk;
    const uint32_t bytes =
        static_cast<uint32_t>(min(chunk, klen - c * chunk)) * h0 * 4;
    // The threads' writes into the slot come before the copy into it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(bars + slot, bytes);
    bulk_load(smem + slot * lay.stage,
              weights + t.w0 + kc * h0, bytes,
              bars + slot);
    if (c == chunks - 1) {
      const uint32_t run = static_cast<uint32_t>(lay.later_floats) * 4;
      mbar_expect(later_bar, run);
      bulk_load(smem + lay.later, weights + t.later, run, later_bar);
    }
  };
  if (tid == 0) {
    for (int c = 0; c < min(chunks, lay.slots); ++c) stage(c);
    if (chunks == 0) {
      const uint32_t run = static_cast<uint32_t>(lay.later_floats) * 4;
      mbar_expect(later_bar, run);
      bulk_load(smem + lay.later, weights + t.later, run, later_bar);
    }
  }
  // The granules of each row's slice of x, and where the slice starts in
  // the first (a shift of 0 to 3 words).
  float* xs = smem + lay.x;
  {
    const int span = (3 + klen + 3) / 4;
    for (int i = tid; i < g_rows * span; i += kThreads) {
      const int m = i / span;
      const int g = i - m * span;
      const float* from = input(m, k0);
      const int shift = offset(from);
      if (g < (shift + klen + 3) / 4) {
        copy_16(xs + m * lay.pitch + 4 * g, from - shift + 4 * g);
      }
    }
    copy_commit();
    copy_wait_all();
    __syncthreads();
    if (klen % 4) {
      // Zero past the slice's end to its last quad's end.
      for (int i = tid; i < g_rows * 4; i += kThreads) {
        const int m = i / 4;
        const int k = klen + i % 4;
        if (k < round_up(klen, 4)) {
          xs[m * lay.pitch + offset(input(m, k0)) + k] = 0.f;
        }
      }
      __syncthreads();
    }
  }
  const float* xr[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int m = i < 4 ? r0 + i : half_rows + r0 + i - 4;
    xr[i] = xs + m * lay.pitch + (m < g_rows ? offset(input(m, k0)) : 0);
  }
  for (int c = 0; c < chunks; ++c) {
    const int slot = c % lay.slots;
    mbar_wait(bars + slot, c / lay.slots & 1);  // Chunk c is in.
    const float* ws = smem + slot * lay.stage;
    const int clen = min(chunk, klen - c * chunk);
    if (clen % 4) {
      // Zero W0's rows past the slice's end to its last quad's end.
      for (int i = tid; i < (round_up(clen, 4) - clen) * h0; i += kThreads) {
        smem[slot * lay.stage + clen * h0 + i] = 0.f;
      }
      __syncthreads();
    }
    if (active) {
      const int quads = (clen + 3) / 4;
      for (int q = kg; q < quads; q += lay.kgroups) {
        const int k = c * chunk + 4 * q;
        float xv[kTile][4];
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) xv[i][kk] = xr[i][k + kk];
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* wk = ws + (4 * q + kk) * h0 + c0;
          const float4 wl = *reinterpret_cast<const float4*>(wk);
          const float4 wh = *reinterpret_cast<const float4*>(wk + half_cols);
          const float wc[kTile] = {wl.x, wl.y, wl.z, wl.w,
                                   wh.x, wh.y, wh.z, wh.w};
#pragma unroll
          for (int i = 0; i < kTile; ++i) {
#pragma unroll
            for (int j = 0; j < kTile; ++j) {
              acc[i][j] = fmaf(xv[i][kk], wc[j], acc[i][j]);
            }
          }
        }
      }
    }
    if (c + lay.slots < chunks) {
      __syncthreads();  // Every warp is done with slot c % slots.
      if (tid == 0) stage(c + lay.slots);
    }
  }
  __syncthreads();  // The ring is free.

  // The k-groups' partials, added in group order into group 0's; then,
  // for each owner q of the group's rows (block group * ks + q, rows
  // [q * owned, (q + 1) * owned)), one bulk copy of those rows into slot
  // kq of its receive buffer.
  float* parts = smem;
  if (active) {
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int m = i < 4 ? r0 + i : half_rows + r0 + i - 4;
      float* dst = parts + (kg * lay.mp + m) * h0 + c0;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(dst + half_cols) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  __syncthreads();
  const int group_stride = lay.mp * h0;
  for (int i = tid; i < g_rows * h0 / 4; i += kThreads) {
    float4* at = reinterpret_cast<float4*>(parts) + i;
    float4 sum = *at;
#pragma unroll 1
    for (int g = 1; g < lay.kgroups; ++g) {
      sum = add4(sum, *reinterpret_cast<const float4*>(
                          parts + g * group_stride + 4 * i));
    }
    *at = sum;
  }
  // The sums are read by the copy engine: make them visible to it.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  cluster_wait();  // Every block has started and made its mbarrier.
  float* recv = smem + lay.recv;
  const int first = kq * lay.owned;
  const int n_own = max(0, min(lay.owned, g_rows - first));
  if (tid < ks) {
    const int q_rows = min(lay.owned, g_rows - tid * lay.owned);
    if (q_rows > 0) {
      bulk_send(recv + kq * lay.owned * h0, parts + tid * lay.owned * h0,
                static_cast<uint32_t>(q_rows) * h0 * 4, bar, group * ks + tid);
    }
  }
  if (tid == 0) {
    mbar_expect(bar, static_cast<uint32_t>(ks) * n_own * h0 * 4);
  }
  mbar_wait(bar, 0);        // Every partial of this block's rows is in;
  mbar_wait(later_bar, 0);  // so is the run b0, W1, ....
  cluster_arrive();  // So every copy out of this block has landed.

  // This block's rows: group rows [first, first + n_own). Their first
  // layer is the ks partials in slice order; over several clusters (tower
  // 1 only, one row group), each cluster's sum goes to device memory and
  // the block of the last cluster to arrive there adds them in cluster
  // order and goes on, the others stop. Then the bias, the ReLU.
  float* in = smem + lay.act;
  float* to = in + lay.owned * lay.widest;
  const float* later = smem + lay.later;
  const int clusters = t.clusters;
  for (int i = tid; i < n_own * h0 / 4; i += kThreads) {
    const int j = i / (h0 / 4);
    const int k = 4 * i - j * h0;
    const float* at = recv + j * h0 + k;
    float4 sum = *reinterpret_cast<const float4*>(at);
#pragma unroll 1
    for (int r = 1; r < ks; ++r) {
      sum = add4(sum, *reinterpret_cast<const float4*>(
                          at + r * lay.owned * h0));
    }
    *reinterpret_cast<float4*>(in + j * lay.widest + k) = sum;
    if (clusters > 1) {
      __stcg(reinterpret_cast<float4*>(
                 scratch + ((part * ks + kq) * lay.owned + j) * h0 + k),
             sum);
    }
  }
  if (clusters > 1) {
    __threadfence();  // This cluster's sums are in device memory ...
    __syncthreads();
    if (tid == 0) *arrived = atomicAdd(arrivals + kq, 1);  // ... before this.
    __syncthreads();
  }
  const bool last = clusters == 1 || *arrived == clusters - 1;
  if (last) {
    if (clusters > 1) __threadfence();
    for (int i = tid; i < n_own * h0 / 4; i += kThreads) {
      const int j = i / (h0 / 4);
      const int k = 4 * i - j * h0;
      float4* at = reinterpret_cast<float4*>(in + j * lay.widest + k);
      float4 sum = *at;
      if (clusters > 1) {
        const float* from = scratch + (kq * lay.owned + j) * h0 + k;
        sum = part == 0 ? sum : __ldcg(reinterpret_cast<const float4*>(from));
#pragma unroll 1
        for (int c = 1; c < clusters; ++c) {
          sum = add4(sum, c == part ? *at
                                    : __ldcg(reinterpret_cast<const float4*>(
                                          from + c * ks * lay.owned * h0)));
        }
      }
      const float4 bv = *reinterpret_cast<const float4*>(later + k);
      *at = make_float4(relu(sum.x + bv.x), relu(sum.y + bv.y),
                        relu(sum.z + bv.z), relu(sum.w + bv.w));
    }
    if (clusters > 1 && tid == 0) arrivals[kq] = 0;  // For the next launch.
  }
  __syncthreads();

  // The later layers on this block's rows. An output's dot product is
  // shared by `split` adjacent lanes (the input quads q = lane mod split,
  // each in four chains of k mod 4), whose sums a butterfly adds; then
  // the bias, and the ReLU but after the last layer.
  const float* w = later + h0;
  int in_w = h0;
  for (int l = 1; last && l < plan.depth; ++l) {
    const int out_w = plan.widths[l];
    const bool last = l == plan.depth - 1;
    const float* bias = w + in_w * out_w;
    const int items = n_own * out_w;
    int split = 1;
    while (split < kMaxSplit && items * split * 2 <= kThreads) split *= 2;
    for (int base = 0; base < items * split; base += kThreads) {
      const int i = (base + tid) / split;
      const int part = (base + tid) % split;
      const int j = i / out_w;
      const int n = i - j * out_w;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      if (i < items) {
        const float* a = in + j * lay.widest;
#pragma unroll 1
        for (int k = 4 * part; k < in_w; k += 4 * split) {
          const float4 av = *reinterpret_cast<const float4*>(a + k);
          c[0] = fmaf(av.x, w[k * out_w + n], c[0]);
          c[1] = fmaf(av.y, w[(k + 1) * out_w + n], c[1]);
          c[2] = fmaf(av.z, w[(k + 2) * out_w + n], c[2]);
          c[3] = fmaf(av.w, w[(k + 3) * out_w + n], c[3]);
        }
      }
      float v = (c[0] + c[1]) + (c[2] + c[3]);
      for (int step = 1; step < split; step *= 2) {
        v += __shfl_xor_sync(0xffffffffu, v, step);
      }
      if (i < items && part == 0) {
        v += bias[n];
        if (!last) {
          to[j * lay.widest + n] = relu(v);
        } else if (n < plan.dims) {
          out[(g0 + first + j) * plan.dims + n] = v;
        }
      }
    }
    __syncthreads();
    float* done = in;
    in = to;
    to = done;
    w = bias + out_w;
    in_w = out_w;
  }
  cluster_wait();  // No block leaves before its copies have landed.
}

}  // namespace towers

// x1 [rows, F1]; x2a and x2b [rows, F2] (x2b null for one stream), all
// contiguous float32; weights packed by ops/dcca_towers.py::TowerWeights;
// h1 [rows, dims] and h2 [streams, rows, dims]. The kernel's attributes
// are set once per device; a launch the card refuses returns its error.
extern "C" int tdt_dcca_towers(const float* x1, const float* x2a,
                               const float* x2b, const float* weights,
                               float* h1, float* h2, float* scratch,
                               int* arrivals, const towers::Plan* p,
                               void* stream) {
  using namespace towers;
  bool ok = p->rows >= 1 && p->rows <= kMaxRows && p->depth >= 2 &&
            p->depth <= kMaxLayers && p->cluster >= 1 &&
            p->cluster <= kMaxCluster && p->widths[0] % (2 * kTile) == 0 &&
            p->dims >= 1 && p->dims <= p->widths[p->depth - 1] &&
            (x2b != nullptr) == (p->tower[1].streams == 2) &&
            p->tower[0].streams == 1;
  for (int i = 0; ok && i < p->depth; ++i) {
    ok = p->widths[i] >= 4 && p->widths[i] <= kMaxWidth &&
         p->widths[i] % 4 == 0;
  }
  size_t smem = 0;
  for (int i = 0; ok && i < 2; ++i) {
    const Tower& t = p->tower[i];
    ok = t.width >= 1 && t.kslices >= 1 && p->cluster % t.kslices == 0 &&
         t.slice >= 1 && t.slice <= (1 << 16) && t.chunk >= 1 &&
         t.chunk <= kMaxChunk &&
         static_cast<long long>(t.slice) * t.kslices * t.clusters >=
             t.width &&
         t.group_rows >= 1 && t.group_rows <= kMaxRows &&
         t.group_rows * (p->cluster / t.kslices) >= t.streams * p->rows &&
         t.w0 % 4 == 0 && t.later % 4 == 0 &&
         (t.clusters == 1 || (i == 0 && (t.clusters == 2 || t.clusters == 4) &&
                              t.kslices == p->cluster &&
                              t.group_rows >= p->rows && scratch != nullptr &&
                              arrivals != nullptr));
    if (!ok) break;
    const Layout lay = layout(*p, t);
    ok = lay.tpg <= kThreads;
    const size_t bytes = static_cast<size_t>(lay.total_bytes);
    smem = bytes > smem ? bytes : smem;
  }
  if (!ok || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dcca_towers_kernel;
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
  config.gridDim = dim3(static_cast<unsigned>(p->cluster),
                        static_cast<unsigned>(p->tower[0].clusters) + 1);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, x1, x2a, x2b, weights, h1, h2,
                           scratch, arrivals, *p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
