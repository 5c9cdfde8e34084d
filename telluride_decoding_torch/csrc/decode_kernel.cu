// Fused CCA decode (K1) for Hopper: a tensor-core kernel for bf16 windows
// and a CUDA-core kernel for float32 ones, behind one C interface each.
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
// are projected once and scored against both streams. The rotations are
// rounded to the inputs' dtype by the caller, as the JAX kernel does.
//
// bf16 (fused_cca_decode_mma_kernel). Bound on this card: reading x1. At
// the flagship, 512 windows x 100 frames x 2553 bf16, x1 is 261.4 MB of
// the 264.7 MB that must move: 0.079 ms at 3.35 TB/s. Its products,
// bf16 x bf16 summed in fp32, are 2.6 GFLOP: 39 us of fp32 FMAs on CUDA
// cores, 3 us on the tensor cores, which compute exactly that semantics
// (the JAX kernel's preferred_element_type=float32). Design:
//   * a block owns whole windows (ceil(W / #SMs) of them, one block an SM)
//     and walks their rows in groups of 16, the m of mma.m16n8k16, so no
//     score crosses blocks and no atomics are needed;
//   * each group's 16 rows go into shared memory in two stages (81.7 KB
//     each at 2553 features), so the copy of group g+1 is in flight while
//     group g is multiplied. x1's row pitch (5106 bytes at 2553) is not a
//     multiple of 16 bytes, so neither a TMA tiled map nor ldmatrix can
//     address it, and 16-byte cp.async would take 20 instructions a
//     thread a group and stall the warps that multiply. Instead each row's
//     span, from its 16-byte aligned-down start, is one bulk copy
//     (cp.async.bulk, the copy engine without a tensor map) issued by a
//     lane of warp 0, completing on the stage's mbarrier; rows are read
//     back at their true offset;
//   * the feature axis is split over the 8 warps in k-steps of 16 (warp w
//     takes steps w, w + 8, ...); each warp holds its steps of rot1, rounded
//     to bf16, zero-padded to 16 columns and packed in B-fragment order, in
//     registers (4 a step), so rot1 takes no shared memory and no load in
//     the loop. Within a step the features are permuted so that a lane's
//     four A elements of a row are consecutive: two aligned 8-byte shared
//     loads and two byte permutes a row instead of four 16-bit loads, and
//     the row pitch keeps those loads free of bank conflicts. Features
//     at or past F1 are zero in A too, so a non-finite value in the next
//     row or past the tensor cannot leak into a window;
//   * a warp loads the next k-step's words before it issues this step's two
//     mma.sync.m16n8k16 bf16 -> f32 (the two n8 tiles of D <= 16 columns),
//     and alternates two sets of accumulators, so neither the shared loads
//     nor the accumulation chain stall every step;
//   * per group, warp 5 + s also multiplies stream s's x2 rows (staged
//     beside x1) by rot2, packed the same way, on the tensor cores; the
//     warps' [16, 16] partial sums of r1 are then added through shared
//     memory in warp order, each row is scored by 16 threads, and at the
//     next group's start warp 7 adds the row scores to their windows' sums
//     with a segmented scan in a fixed lane order. The result does not
//     depend on scheduling. Warp 0 issues the copies, so each extra duty
//     falls on another warp.
// Rows wider than a chunk (the wrapper's choice, at most 3072 features)
// are walked chunk by chunk, the B fragments reloaded from device memory
// for each; at 2553 and 1408 features a row is one chunk.
//
// float32 (fused_cca_decode_cluster_kernel): the serving decode, windows of
// T = 1 in chunks of up to 32 frames, pair form, at 2553 (D 10) and 1408
// (D 5) features, and every other float32 call. The products are exact
// fp32 FMAs on the CUDA cores (served scores stay within 1e-4 of the plain
// decode; TF32 would not). A served chunk's bytes (0.44 MB at 2553) take
// 0.13 us at 3.35 TB/s, so latency bounds it: the launch, one round trip
// of x1 from device memory and the chain of work after it, which one block
// on one SM used to serialise. Design:
//   * a cluster of C blocks owns a tile of whole windows: as many as fit in
//     32 rows, or one longer window whose rows are walked 32 at a time.
//     Block k takes a contiguous slice of about F1 / C features of each
//     row, so a served chunk spreads over C = 16 SMs; with many tiles C
//     falls so that the tiles just fill the card (ops/decode_kernel.py::
//     f32_plan);
//   * the block stages its slice of the group's rows and of rot1 (D padded
//     to 16 columns) a chunk of features at a time with 4- and 16-byte
//     cp.async copies from all threads, so every load is in flight at once
//     and, in two stages, chunk c + 1 is copied while chunk c is multiplied;
//   * warp w multiplies rows w, w + 8, w + 16, w + 24 by all 16 columns,
//     its lanes on consecutive features: 4 words of x1 and 4 float4s of
//     rot1 feed 64 FMAs, and rot1's row quarters are rotated in shared
//     memory so the float4 loads are free of bank conflicts. A butterfly
//     reduce-scatter over the lanes leaves each lane two sums;
//   * each row is scored by the block whose rank is its window modulo C:
//     every block sends its partial r1 of the row there (a store into that
//     block's shared memory through cluster.map_shared_rank), and after
//     one cluster barrier a group the owner adds the C partials in rank
//     order, scores the row against both x2 streams (r2 from the x2 rows it
//     staged, computed while the barrier is pending), sums the columns with
//     a butterfly and the rows into their window's mean in row order. No
//     float atomics, no global scratch, one launch: the result does not
//     depend on scheduling. Partials alternate between two buffers, and
//     nothing remote is touched after the last barrier, so no block waits
//     for the others to exit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace f32 {

// Must match the F32_* constants, f32_plan and f32_smem_bytes in
// ops/decode_kernel.py.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;               // Rows (frames) a group.
constexpr int kRows = kGroup / kWarps;   // A warp's rows: warp + 8 i.
constexpr int kCols = 16;                // D <= 16, zero-padded.
constexpr int kMaxCluster = 16;
constexpr size_t kMaxSmem = 232448;

struct Layout {
  int pitch;  // fp32 words a staged x1 row.
  size_t rot, recv, r2, x2, rot2, consts, scores, rows, win, total;
};

// Shared memory, in this order: x1 rows [stage][kGroup][pitch]; rot1
// [stage][chunk][kCols]; the partial r1 sent here [2][kGroup][cluster]
// [kCols]; r2 [kGroup][stream][kCols]; x2 rows [stream][kGroup][f2]; rot2
// [f2][kCols]; c1, c2, scale and the intercept; row scores [kGroup]
// [stream]; the owned rows' indices [kGroup]; window sums [stream]
// [windows_per_tile].
__host__ __device__ inline Layout layout(int chunk, int f2, int cluster,
                                         int windows_per_tile) {
  Layout l;
  l.pitch = (chunk + 3) / 4 * 4;
  const size_t group = kGroup;
  l.rot = 2 * group * l.pitch * 4;
  l.recv = l.rot + 2 * static_cast<size_t>(chunk) * kCols * 4;
  l.r2 = l.recv + 2 * group * cluster * kCols * 4;
  l.x2 = l.r2 + group * 2 * kCols * 4;
  l.rot2 = l.x2 + 2 * group * f2 * 4;
  l.consts = l.rot2 + static_cast<size_t>(f2) * kCols * 4;
  l.scores = l.consts + ((3 * kCols + 1) * 4 + 15) / 16 * 16;
  l.rows = l.scores + 2 * group * 4;
  l.win = l.rows + group * 4;
  l.total = l.win + 2 * static_cast<size_t>(windows_per_tile) * 4;
  return l;
}

// The two halves of a cluster barrier: arrive (releasing this thread's
// writes to the cluster's shared memory, or relaxed) and wait (acquiring
// the others').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies into shared memory (cp.async): a 4-byte word at any
// word address, 16 bytes between 16-byte aligned addresses. A group of
// them is closed by copy_commit; copy_wait<n> waits until at most n of
// this thread's groups are in flight.
__device__ __forceinline__ void copy_word(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Where feature k's columns 4 q .. 4 q + 3 sit in a staged chunk of rot1:
// the four 16-byte quarters of a row rotate by k / 2, so the 8 lanes of a
// quarter-warp, on 8 consecutive features, read 8 different bank quads.
__device__ __forceinline__ int rot_word(int k, int q) {
  return k * kCols + 4 * ((q + (k >> 1)) & 3);
}

// One step of a warp's reduce-scatter: lanes that differ in bit `offset`
// swap halves of their 2H live values and add, so each keeps H sums.
template <int H>
__device__ __forceinline__ void fold(float (&v)[kRows * kCols], int lane,
                                     int offset) {
  const bool upper = lane & offset;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = upper ? v[j] : v[j + H];
    const float keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, offset);
  }
}

// At most 128 registers a thread, so two blocks fit on an SM when a plan
// puts two there (f32_plan).
__global__ void __launch_bounds__(kThreads, 2)
fused_cca_decode_cluster_kernel(const float* __restrict__ x1,
                                const float* __restrict__ x2a,
                                const float* __restrict__ x2b,
                                const float* __restrict__ rot1,
                                const float* __restrict__ rot2,
                                const float* __restrict__ consts_in,
                                float* __restrict__ out_a,
                                float* __restrict__ out_b, int windows,
                                int frames, int f1, int f2, int dims,
                                int windows_per_tile, int slice, int chunk) {
  extern __shared__ __align__(16) unsigned char f32_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // Every block of the cluster has started before any writes to another.
  cluster_arrive_relaxed();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const Layout lay = layout(chunk, f2, csize, windows_per_tile);
  float* xs = reinterpret_cast<float*>(f32_smem);
  float* rot_s = reinterpret_cast<float*>(f32_smem + lay.rot);
  float* recv = reinterpret_cast<float*>(f32_smem + lay.recv);
  float* r2_s = reinterpret_cast<float*>(f32_smem + lay.r2);
  float* x2_s = reinterpret_cast<float*>(f32_smem + lay.x2);
  float* rot2_s = reinterpret_cast<float*>(f32_smem + lay.rot2);
  float* consts = reinterpret_cast<float*>(f32_smem + lay.consts);
  float* scores = reinterpret_cast<float*>(f32_smem + lay.scores);
  int* rows_s = reinterpret_cast<int*>(f32_smem + lay.rows);
  float* win = reinterpret_cast<float*>(f32_smem + lay.win);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool pair = x2b != nullptr;
  const int streams = pair ? 2 : 1;
  const int k0 = rank * slice;                   // This block's features.
  const int len = max(0, min(slice, f1 - k0));
  const int chunks = max(1, (len + chunk - 1) / chunk);
  const int w0 = static_cast<int>(blockIdx.x) / csize * windows_per_tile;
  const int nw = min(windows_per_tile, windows - w0);
  const long long row_begin = static_cast<long long>(w0) * frames;
  // A tile's rows fit an int: up to 32, or one window's frames.
  const int tile_rows = nw * frames;
  const int groups = (tile_rows + kGroup - 1) / kGroup;
  const int tile_size = csize * kCols;  // recv floats a row.
  auto x2_row = [&](int s, long long row) {
    return (s == 0 ? x2a : x2b) + row * f2;
  };

  // rot2 and the constants, once; they land with the first chunk.
  for (int i = tid; i < f2 * kCols / 4; i += kThreads) {
    copy_16(rot2_s + 4 * i, rot2 + 4 * i);
  }
  for (int i = tid; i < 3 * kCols + 1; i += kThreads) {
    copy_word(consts + i, consts_in + i);
  }
  for (int i = tid; i < 2 * windows_per_tile; i += kThreads) win[i] = 0.f;

  for (int g = 0; g < groups; ++g) {
    const int group_row = g * kGroup;
    const int nrows = min(kGroup, tile_rows - group_row);
    const float* x1_rows = x1 + (row_begin + group_row) * f1 + k0;
    // Row r (lane r) is scored by the block whose rank is its window
    // modulo csize; its slot is its place, in row order, among that
    // block's rows (every warp computes the same).
    const int owner = lane < nrows ? (group_row + lane) / frames % csize : -1;
    const int slot = __popc(__match_any_sync(0xffffffffu, owner) &
                            ((1u << lane) - 1u));
    const uint32_t owned = __ballot_sync(0xffffffffu, owner == rank);
    const int n_owned = __popc(owned);
    // Chunk c of the group's rows of the slice into stage c % 2 (a warp a
    // row, lanes on consecutive words), with its features of rot1.
    auto stage_chunk = [&](int c) {
      const int kc = c * chunk;
      const int clen = min(chunk, len - kc);
      float* xd = xs + (c & 1) * kGroup * lay.pitch;
      for (int r = warp; r < nrows; r += kWarps) {
        const float* src = x1_rows + static_cast<long long>(r) * f1 + kc;
        for (int k = lane; k < clen; k += 32) {
          copy_word(xd + r * lay.pitch + k, src + k);
        }
      }
      float* rd = rot_s + (c & 1) * chunk * kCols;
      const float* rsrc = rot1 + static_cast<size_t>(k0 + kc) * kCols;
      for (int i = tid; i < clen * 4; i += kThreads) {
        copy_16(rd + rot_word(i >> 2, i & 3), rsrc + 4 * i);
      }
    };
    stage_chunk(0);
    // The owned rows' x2 rows, with the first chunk; each owned row's
    // index in the tile by its slot.
    for (int p = warp; p < n_owned * streams; p += kWarps) {
      const int s = p / n_owned;
      const int j = p - s * n_owned;
      uint32_t m = owned;
      for (int q = 0; q < j; ++q) m &= m - 1;
      const int row = group_row + __ffs(m) - 1;
      if (lane == 0) rows_s[j] = row;
      const float* src = x2_row(s, row_begin + row);
      for (int f = lane; f < f2; f += 32) {
        copy_word(x2_s + (s * kGroup + j) * f2 + f, src + f);
      }
    }
    copy_commit();

    // This warp's rows warp + 8 i times this block's slice of rot1, all 16
    // columns, lanes on consecutive features; chunk c + 1 is in flight
    // while c is multiplied. Rows past the group's end read stale words;
    // their sums are never sent.
    float acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int d = 0; d < kCols; ++d) acc[i][d] = 0.f;
    }
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        stage_chunk(c + 1);
        copy_commit();
        copy_wait<1>();
      } else {
        copy_wait<0>();
      }
      __syncthreads();
      const int clen = max(0, min(chunk, len - c * chunk));
      const float* xw = xs + ((c & 1) * kGroup + warp) * lay.pitch;
      const float* rs = rot_s + (c & 1) * chunk * kCols;
#pragma unroll 2
      for (int k = lane; k < clen; k += 32) {
        float xv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) xv[i] = xw[i * kWarps * lay.pitch + k];
#pragma unroll
        for (int q = 0; q < kCols / 4; ++q) {
          const float4 rv =
              *reinterpret_cast<const float4*>(rs + rot_word(k, q));
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            acc[i][4 * q] = fmaf(xv[i], rv.x, acc[i][4 * q]);
            acc[i][4 * q + 1] = fmaf(xv[i], rv.y, acc[i][4 * q + 1]);
            acc[i][4 * q + 2] = fmaf(xv[i], rv.z, acc[i][4 * q + 2]);
            acc[i][4 * q + 3] = fmaf(xv[i], rv.w, acc[i][4 * q + 3]);
          }
        }
      }
      __syncthreads();  // Stage c % 2 is free for chunk c + 2.
    }

    // The warp's sums over its lanes (a fixed butterfly): lane L ends with
    // row warp + 8 (L / 8), columns 2 (L % 8) and 2 (L % 8) + 1, which it
    // sends to the block that scores the row, at this block's rank.
    float v[kRows * kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int d = 0; d < kCols; ++d) v[i * kCols + d] = acc[i][d];
    }
    fold<32>(v, lane, 16);
    fold<16>(v, lane, 8);
    fold<8>(v, lane, 4);
    fold<4>(v, lane, 2);
    fold<2>(v, lane, 1);
    const int row = warp + kWarps * (lane >> 3);
    const int row_owner = __shfl_sync(0xffffffffu, owner, row);
    const int row_slot = __shfl_sync(0xffffffffu, slot, row);
    if (g == 0) cluster_wait();  // Every block has started.
    if (row < nrows) {
      float* dst = recv + ((g & 1) * kGroup + row_slot) * tile_size +
                   rank * kCols + 2 * (lane & 7);
      *reinterpret_cast<float2*>(cluster.map_shared_rank(dst, row_owner)) =
          make_float2(v[0], v[1]);
    }
    cluster_arrive();  // This block's partial r1 of the group is sent.

    // r2 of this block's rows while the others send: item i = (slot,
    // stream, column), the same thread as below.
    const int items = n_owned * 2 * kCols;
    for (int i = tid; i < items; i += kThreads) {
      const int d = i % kCols;
      const int s = i / kCols & 1;
      if (s < streams && d < dims) {
        const float* x2 = x2_s + (s * kGroup + i / (2 * kCols)) * f2;
        float part2[4] = {0.f, 0.f, 0.f, 0.f};  // Four chains, fixed order.
        int f = 0;
        for (; f + 4 <= f2; f += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            part2[u] = fmaf(x2[f + u], rot2_s[(f + u) * kCols + d], part2[u]);
          }
        }
        for (; f < f2; ++f) {
          part2[0] = fmaf(x2[f], rot2_s[f * kCols + d], part2[0]);
        }
        r2_s[i] = (part2[0] + part2[1]) + (part2[2] + part2[3]);
      }
    }
    cluster_wait();  // Every block's partials of this block's rows are in.

    // Score this block's rows: r1 is the partials in rank order; a row's
    // columns are summed by a butterfly over its 16 lanes.
    for (int base = 0; base < items; base += kThreads) {
      const int i = base + tid;
      const int d = i % kCols;
      float term = 0.f;
      if (i < items) {
        const int s = i / kCols & 1;
        if (s < streams && d < dims) {
          const float* sent =
              recv + ((g & 1) * kGroup + i / (2 * kCols)) * tile_size + d;
          float r1 = sent[0];
#pragma unroll
          for (int q = 1; q < kMaxCluster; ++q) {
            if (q < csize) r1 += sent[q * kCols];
          }
          term = (r1 - consts[d]) * (r2_s[i] - consts[kCols + d]) *
                 consts[2 * kCols + d];
        }
      }
#pragma unroll
      for (int offset = kCols / 2; offset > 0; offset >>= 1) {
        term += __shfl_xor_sync(0xffffffffu, term, offset);
      }
      if (i < items && d == 0) scores[i / kCols] = term;
    }
    __syncthreads();
    // Each window's rows of the group (consecutive slots), summed in row
    // order by the thread of its first, onto the window's sum; a window's
    // mean is written with its last row.
    for (int i = tid; i < 2 * n_owned; i += kThreads) {
      const int s = i & 1;
      const int j = i >> 1;
      const int w = rows_s[j] / frames;
      if (s >= streams || (j > 0 && rows_s[j - 1] / frames == w)) continue;
      float sum = scores[i];
      int last = j;
      while (last + 1 < n_owned && rows_s[last + 1] / frames == w) {
        sum += scores[2 * ++last + s];
      }
      float& total = win[s * windows_per_tile + w];
      total += sum;
      if ((rows_s[last] + 1) % frames == 0) {
        (s == 0 ? out_a : out_b)[w0 + w] =
            total / static_cast<float>(frames) + consts[3 * kCols];
      }
    }
    if (g + 1 < groups) __syncthreads();  // rows_s, scores are free.
  }
}

}  // namespace f32

namespace mma {

// Must match the MMA_* constants and mma_smem_bytes in
// ops/decode_kernel.py.
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;      // m of mma.m16n8k16: rows (frames) a group.
constexpr int kCols = 16;      // Two n8 tiles: D <= 16.
constexpr int kStep = 16;      // k of mma.m16n8k16: features a k-step.
constexpr int kMaxSteps = 24;  // k-steps a warp holds per chunk.
constexpr int kMaxChunk = kWarps * kMaxSteps * kStep;  // 3072 features.
// bf16 past a chunk in a staged row: room for the alignment shift and the
// last 16-byte granule, and a row pitch of 8 words modulo the 32 banks, so
// that the four rows a half-warp reads with 8-byte loads fall on
// different banks.
constexpr int kPitchPad = 16;
constexpr size_t kMaxSmem = 232448;

struct Layout {
  size_t x1_stage, x2_stage, x2, red, r2, bars, b2, consts, scores, win, total;
};

__host__ __device__ inline Layout layout(int chunk, int f2,
                                         int windows_per_block) {
  Layout l;
  l.x1_stage = static_cast<size_t>(kRows) * (chunk + kPitchPad) * 2;
  l.x2_stage = (static_cast<size_t>(kRows) * f2 * 2 + 29) / 16 * 16;
  l.x2 = 2 * l.x1_stage;                          // [stage][stream]
  l.red = l.x2 + 4 * l.x2_stage;                  // [kWarps][kRows][kCols]
  l.r2 = l.red + kWarps * kRows * kCols * 4;      // [stream][kRows][kCols]
  l.bars = l.r2 + 2 * kRows * kCols * 4;          // [stage] mbarrier
  l.b2 = l.bars + 2 * 8;                          // [ceil(f2 / 16)][32] x 16 B
  l.consts = l.b2 + static_cast<size_t>((f2 + kStep - 1) / kStep) * 32 * 16;
  l.scores = l.consts + (3 * kCols + 1) * 4;      // [stream][kRows]
  l.win = l.scores + 2 * kRows * 4;               // [stream][windows_per_block]
  l.total = l.win + 2 * static_cast<size_t>(windows_per_block) * 4;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives on bar and makes its phase wait for `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Byte offset of p within its 16-byte granule.
__device__ __forceinline__ int granule_shift(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// The 16-byte granules that hold bytes [src, src + bytes): src lands at
// their start + granule_shift(src). They each hold a byte of the span, so
// reading them never leaves its pages.
struct Span {
  const unsigned char* start;
  uint32_t bytes;
};

__device__ __forceinline__ Span granules(const void* src, long long bytes) {
  const int shift = granule_shift(src);
  return {static_cast<const unsigned char*>(src) - shift,
          bytes > 0 ? static_cast<uint32_t>((shift + bytes + 15) & ~15LL) : 0u};
}

// One bulk (TMA, no tensor map) copy of a span into shared memory; bar's
// phase completes when all the bytes it expects have landed.
__device__ __forceinline__ void bulk_copy(void* dst, const Span& span,
                                          uint64_t* bar) {
  if (span.bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(span.start), "r"(span.bytes),
         "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// D += A * B for one n8 tile: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col),
// D 16 x 8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of one k-step whose features may end inside it: lane (g, c)
// takes features k .. k + 3 (k = 16 s + 4 c, the permutation of
// pack_mma_b) of rows lo and hi, zero at or past len.
__device__ __forceinline__ void masked_a(uint32_t (&a)[4], const uint16_t* lo,
                                         const uint16_t* hi, int k, int len) {
  uint16_t l[4], h[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    l[q] = k + q < len ? lo[k + q] : 0;
    h[q] = k + q < len ? hi[k + q] : 0;
  }
  a[0] = pack(l[0], l[1]);
  a[1] = pack(h[0], h[1]);
  a[2] = pack(l[2], l[3]);
  a[3] = pack(h[2], h[3]);
}

// Stores a warp's two n8 tiles as rows of a [kRows][kCols] fp32 tile.
__device__ __forceinline__ void store_tile(float* tile, const float (&d)[2][4],
                                           int g, int c) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int col = 8 * t + 2 * c;
    tile[g * kCols + col] = d[t][0];
    tile[g * kCols + col + 1] = d[t][1];
    tile[(g + 8) * kCols + col] = d[t][2];
    tile[(g + 8) * kCols + col + 1] = d[t][3];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_cca_decode_mma_kernel(const __nv_bfloat16* __restrict__ x1,
                            const __nv_bfloat16* __restrict__ x2a,
                            const __nv_bfloat16* __restrict__ x2b,
                            const uint4* __restrict__ b1_packed,
                            const uint4* __restrict__ b2_packed,
                            const float* __restrict__ consts_in,
                            float* __restrict__ out_a,
                            float* __restrict__ out_b, int windows,
                            int frames, int f1, int f2, int dims, int chunk,
                            int windows_per_block) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  unsigned char* smem = mma_smem;
  const Layout lay = layout(chunk, f2, windows_per_block);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* r2_tile = reinterpret_cast<float*>(smem + lay.r2);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint4* b2 = reinterpret_cast<uint4*>(smem + lay.b2);
  float* consts = reinterpret_cast<float*>(smem + lay.consts);
  float* row_score = reinterpret_cast<float*>(smem + lay.scores);
  float* win_sum = reinterpret_cast<float*>(smem + lay.win);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // Fragment row (and B column) of this lane.
  const int c = lane & 3;   // Fragment column pair of this lane.
  const bool pair = x2b != nullptr;
  const int streams = pair ? 2 : 1;
  const int steps2 = (f2 + kStep - 1) / kStep;

  for (int i = tid; i < steps2 * 32; i += kThreads) b2[i] = b2_packed[i];
  for (int i = tid; i < 3 * kCols + 1; i += kThreads) consts[i] = consts_in[i];
  for (int i = tid; i < 2 * windows_per_block; i += kThreads) win_sum[i] = 0.f;
  if (tid == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
  }
  __syncthreads();

  const int w0 = blockIdx.x * windows_per_block;
  const int nw = min(windows_per_block, windows - w0);
  const long long row_begin = static_cast<long long>(w0) * frames;
  const long long row_end = row_begin + static_cast<long long>(nw) * frames;
  const long long groups = (row_end - row_begin + kRows - 1) / kRows;
  const int chunks = f1 > chunk ? (f1 + chunk - 1) / chunk : 1;
  const long long items = groups * chunks;   // (group, chunk) pairs.
  const int pitch = chunk + kPitchPad;       // bf16 per staged row.

  // Item i is chunk i % chunks of group i / chunks, staged in stage i % 2
  // (x1 rows, and with a group's last chunk its x2 rows).
  struct Item {
    long long r0;  // First row of the group.
    int nrows, k0, len, stage;
    bool last;     // The group's last chunk.
  };
  auto item = [&](long long i) {
    Item it;
    const long long group = chunks == 1 ? i : i / chunks;
    it.k0 = chunks == 1 ? 0 : static_cast<int>(i - group * chunks) * chunk;
    it.r0 = row_begin + group * kRows;
    it.nrows = row_end - it.r0 < kRows ? static_cast<int>(row_end - it.r0)
                                       : kRows;
    it.len = min(chunk, f1 - it.k0);
    it.stage = static_cast<int>(i & 1);
    it.last = it.k0 + chunk >= f1;
    return it;
  };
  auto x2_rows = [&](const Item& it, int s) {
    return reinterpret_cast<const unsigned char*>(
        (s == 0 ? x2a : x2b) + it.r0 * f2);
  };
  auto x2_stage = [&](const Item& it, int s) {
    return smem + lay.x2 + (2 * it.stage + s) * lay.x2_stage;
  };

  // Warp 0 starts the copies of item i into stage i % 2: lane r < 16 a
  // bulk copy of row r of x1's chunk and, with a group's last chunk, lane
  // 16 + s one of the group's rows of x2 stream s. Stage i % 2's barrier
  // completes when they have landed.
  auto issue = [&](long long i) {
    if (i >= items) return;
    const Item it = item(i);
    Span span = {nullptr, 0u};
    unsigned char* dst = nullptr;
    if (lane < it.nrows) {
      span = granules(x1 + (it.r0 + lane) * f1 + it.k0, 2LL * it.len);
      dst = smem + it.stage * lay.x1_stage +
            static_cast<size_t>(lane) * pitch * 2;
    } else if (lane >= kRows && lane - kRows < (it.last ? streams : 0)) {
      span = granules(x2_rows(it, lane - kRows), 2LL * it.nrows * f2);
      dst = x2_stage(it, lane - kRows);
    }
    uint32_t bytes = span.bytes;
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      bytes += __shfl_xor_sync(0xffffffffu, bytes, offset);
    }
    // The stage was last read through ordinary loads; order those before
    // the copy engine's writes.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0) mbar_expect(&full[it.stage], bytes);
    __syncwarp();
    bulk_copy(dst, span, &full[it.stage]);
  };

  // Adds a group's row scores to their windows' sums: warp 7, lanes 0-15
  // for the first stream and 16-31 for the second, one lane a row. A
  // segmented scan over the lanes in a fixed order sums each window's rows
  // of the group, and the lane of its last row adds that to the window's
  // sum. Groups come in row order, so the window and frame of the group's
  // first row carry over.
  int window = 0;
  int frame = 0;
  auto add_windows = [&](int nrows) {
    if (warp != kWarps - 1) return;
    const int s = lane >> 4;
    const int r = lane & 15;
    const bool active = s < streams && r < nrows;
    float v = active ? row_score[s * kRows + r] : 0.f;
    const int w = (frame + r) / frames;  // The row's window after `window`.
#pragma unroll
    for (int d = 1; d < kRows; d <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, d, kRows);
      const int w_up = __shfl_up_sync(0xffffffffu, w, d, kRows);
      if (r >= d && w_up == w) v += up;
    }
    const int w_next = __shfl_down_sync(0xffffffffu, w, 1, kRows);
    if (active && (r == nrows - 1 || w_next != w)) {
      win_sum[s * windows_per_block + window + w] += v;
    }
    frame += nrows;
    window += frame / frames;
    frame %= frames;
  };

  uint4 b[kMaxSteps];
  auto load_b = [&](int k0, int len) {
#pragma unroll
    for (int j = 0; j < kMaxSteps; ++j) {
      const int kb = (j * kWarps + warp) * kStep;
      b[j] = kb < len ? b1_packed[(k0 + kb) / kStep * 32 + lane]
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if (chunks == 1) load_b(0, f1);

  float acc[2][2][4];  // [k-step parity][n8 tile][fragment]
  int pending_rows = 0;  // Rows whose scores await add_windows.
  if (warp == 0) {
    issue(0);
    issue(1);
  }
  for (long long i = 0; i < items; ++i) {
    mbar_wait(&full[i & 1], static_cast<uint32_t>(i >> 1) & 1);
    __syncthreads();  // Item i has landed; the last epilogue is done.
    if (pending_rows) {
      add_windows(pending_rows);
      pending_rows = 0;
    }
    const Item it = item(i);
    if (it.k0 == 0) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][t][q] = 0.f;
        }
      }
    }
    if (chunks > 1) load_b(it.k0, it.len);

    // Rows g and g + 8 of the group at their true offsets (in bf16 from
    // the stage's row starts). Rows past the group's end read stale
    // shared memory; an mma row only feeds its own output row, and those
    // are dropped.
    const unsigned char* stage = smem + it.stage * lay.x1_stage;
    const uint16_t* row_lo = reinterpret_cast<const uint16_t*>(
        stage + static_cast<size_t>(g) * pitch * 2 +
        granule_shift(x1 + (it.r0 + g) * f1 + it.k0));
    const uint16_t* row_hi = reinterpret_cast<const uint16_t*>(
        stage + static_cast<size_t>(g + 8) * pitch * 2 +
        granule_shift(x1 + (it.r0 + g + 8) * f1 + it.k0));
    // A lane takes features 4c .. 4c + 3 of each k-step (pack_mma_b
    // permutes rot1 to match): 8 bytes of a row, which two aligned 8-byte
    // loads hold; a byte permute picks them out at the row's offset o
    // (0, 2, 4 or 6 bytes into the first).
    const int o_lo = static_cast<int>(reinterpret_cast<uintptr_t>(row_lo) & 7);
    const int o_hi = static_cast<int>(reinterpret_cast<uintptr_t>(row_hi) & 7);
    const uint2* words_lo = reinterpret_cast<const uint2*>(
        reinterpret_cast<const unsigned char*>(row_lo) - o_lo) + c;
    const uint2* words_hi = reinterpret_cast<const uint2*>(
        reinterpret_cast<const unsigned char*>(row_hi) - o_hi) + c;
    const uint32_t sel_lo = (o_lo & 2) ? 0x5432u : 0x3210u;
    const uint32_t sel_hi = (o_hi & 2) ? 0x5432u : 0x3210u;
    // This warp's k-steps j take features kb = (8 j + warp) 16 ..; the
    // first nfull are whole, and one more may end inside.
    const int len = it.len;
    const int total = (len + kStep - 1) / kStep;
    const int nsteps = total > warp ? (total - warp + kWarps - 1) / kWarps : 0;
    const int nfull = nsteps - ((len % kStep) && (total - 1) % kWarps == warp);
    uint2 w[4];  // The next whole step's words: row g (0, 1), g + 8 (2, 3).
    auto load_words = [&](int j) {
      const int kw = (j * kWarps + warp) * (kStep / 4);
      w[0] = words_lo[kw];
      w[1] = words_lo[kw + 1];
      w[2] = words_hi[kw];
      w[3] = words_hi[kw + 1];
    };
    // Features 0-1 and 2-3 of the lane from the 16 bytes at p (o >= 4
    // starts in the second word).
    auto pick = [](const uint2& p0, const uint2& p1, int o, uint32_t sel,
                   uint32_t& f01, uint32_t& f23) {
      const uint32_t x0 = o >= 4 ? p0.y : p0.x;
      const uint32_t x1 = o >= 4 ? p1.x : p0.y;
      const uint32_t x2 = o >= 4 ? p1.y : p1.x;
      f01 = __byte_perm(x0, x1, sel);
      f23 = __byte_perm(x1, x2, sel);
    };
    if (nfull > 0) load_words(0);
#pragma unroll
    for (int j = 0; j < kMaxSteps; ++j) {
      uint32_t a[4];
      if (j < nfull) {
        pick(w[0], w[1], o_lo, sel_lo, a[0], a[2]);
        pick(w[2], w[3], o_hi, sel_hi, a[1], a[3]);
        load_words(j + 1 < nfull ? j + 1 : j);  // Ahead of the products.
      } else if (j < nsteps) {  // Zero past the chunk's end, in A too.
        masked_a(a, row_lo, row_hi, (j * kWarps + warp) * kStep + 4 * c, len);
      } else {
        break;
      }
      mma_bf16(acc[j & 1][0], a, b[j].x, b[j].y);
      mma_bf16(acc[j & 1][1], a, b[j].z, b[j].w);
    }
    if (it.last) {
      // The warps' partial [16, 16] products, to be summed in warp order.
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[0][t][q] += acc[1][t][q];
      }
      store_tile(red + warp * kRows * kCols, acc[0], g, c);
      const int r2_stream = warp - (kWarps - 3);  // Warps 5 and 6.
      if (r2_stream >= 0 && r2_stream < streams) {
        // r2 of the stream: x2 rows times rot2, on the tensor cores too.
        const uint16_t* x_lo = reinterpret_cast<const uint16_t*>(
            x2_stage(it, r2_stream) +
            granule_shift(x2_rows(it, r2_stream))) + g * f2;
        const uint16_t* x_hi = x_lo + 8 * f2;
        float r2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int m = 0; m < steps2; ++m) {
          uint32_t a[4];
          masked_a(a, x_lo, x_hi, m * kStep + 4 * c, f2);
          const uint4 bb = b2[m * 32 + lane];
          mma_bf16(r2[0], a, bb.x, bb.y);
          mma_bf16(r2[1], a, bb.z, bb.w);
        }
        store_tile(r2_tile + r2_stream * kRows * kCols, r2, g, c);
      }
    }
    __syncthreads();  // Stage i % 2 is free; the products are complete.
    if (warp == 0) issue(i + 2);
    if (!it.last) continue;

    const int row = tid >> 4;  // 16 threads a row: one per column.
    const int col = tid & 15;
    float r1 = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) r1 += red[(v * kRows + row) * kCols + col];
    float term[2] = {0.f, 0.f};
    if (row < it.nrows && col < dims) {
      for (int s = 0; s < streams; ++s) {
        term[s] = (r1 - consts[col]) *
                  (r2_tile[(s * kRows + row) * kCols + col] -
                   consts[kCols + col]) *
                  consts[2 * kCols + col];
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int offset = 8; offset > 0; offset >>= 1) {
        term[s] += __shfl_xor_sync(0xffffffffu, term[s], offset);
      }
    }
    if (col == 0) {
      row_score[row] = term[0];
      row_score[kRows + row] = term[1];
    }
    pending_rows = it.nrows;
  }
  __syncthreads();
  if (pending_rows) add_windows(pending_rows);
  __syncthreads();

  const float intercept = consts[3 * kCols];
  for (int j = tid; j < nw; j += kThreads) {
    out_a[w0 + j] = win_sum[j] / static_cast<float>(frames) + intercept;
    if (pair) {
      out_b[w0 + j] = win_sum[windows_per_block + j] /
                      static_cast<float>(frames) + intercept;
    }
  }
}

}  // namespace mma

// float32 windows: the shape and launch plan, built once per call
// signature by the caller (ops/decode_kernel.py::F32Plan, the same fields
// in the same order; the plan, cluster blocks a tile of windows_per_tile
// windows, slice features a block, staged chunk at a time, is f32_plan).
struct F32Plan {
  int windows, frames, f1, f2, d, cluster, windows_per_tile, slice, chunk;
};

// rot1 [f1, 16] and rot2 [f2, 16] are zero past column d; consts holds
// c1, c2 and scale (each zero-padded to 16) and the intercept
// (prepared_operands). x2b and out_b are null for the single-stream form.
// The kernel's attributes are set once per device; a cluster launch the
// card refuses returns its error.
extern "C" int tdt_fused_cca_decode(const float* x1, const float* x2a,
                                    const float* x2b, const float* rot1,
                                    const float* rot2, const float* consts,
                                    float* out_a, float* out_b,
                                    const F32Plan* p, void* stream) {
  const int windows = p->windows, frames = p->frames, f1 = p->f1,
            f2 = p->f2, d = p->d, cluster = p->cluster,
            windows_per_tile = p->windows_per_tile, slice = p->slice,
            chunk = p->chunk;
  if (windows <= 0 || frames <= 0 || f1 < 1 || f2 < 0 || d < 1 ||
      d > f32::kCols || cluster < 1 || cluster > f32::kMaxCluster ||
      windows_per_tile < 1 || slice < 1 ||
      static_cast<long long>(slice) * cluster < f1 || chunk < 1 ||
      chunk > slice) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const f32::Layout lay = f32::layout(chunk, f2, cluster, windows_per_tile);
  if (lay.total > f32::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = f32::fused_cca_decode_cluster_kernel;
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
                               static_cast<int>(f32::kMaxSmem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  const int tiles = (windows + windows_per_tile - 1) / windows_per_tile;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles) * cluster);
  config.blockDim = dim3(f32::kThreads);
  config.dynamicSmemBytes = lay.total;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, x1, x2a, x2b, rot1, rot2, consts,
                           out_a, out_b, windows, frames, f1, f2, d,
                           windows_per_tile, slice, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// bf16 windows. b1 and b2 are rot1 and rot2 in B-fragment order
// ([ceil(f / 16), 32] granules of 16 bytes, ops/decode_kernel.py::
// pack_mma_b); consts holds c1, c2 and scale (each zero-padded to 16) and
// the intercept, fp32. chunk is a multiple of 128 up to 3072.
extern "C" int tdt_fused_cca_decode_bf16(
    const void* x1, const void* x2a, const void* x2b, const void* b1,
    const void* b2, const float* consts, float* out_a, float* out_b,
    int windows, int frames, int f1, int f2, int d, int chunk,
    int windows_per_block, void* stream) {
  if (windows <= 0 || frames <= 0 || windows_per_block <= 0 || f1 < 0 ||
      f2 < 0 || d < 1 || d > mma::kCols || chunk < 128 || chunk % 128 != 0 ||
      chunk > mma::kMaxChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const mma::Layout lay = mma::layout(chunk, f2, windows_per_block);
  if (lay.total > mma::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = mma::fused_cca_decode_mma_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (windows + windows_per_block - 1) / windows_per_block;
  kernel<<<blocks, mma::kThreads, lay.total,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x1),
      static_cast<const __nv_bfloat16*>(x2a),
      static_cast<const __nv_bfloat16*>(x2b),
      static_cast<const uint4*>(b1), static_cast<const uint4*>(b2), consts,
      out_a, out_b,
      windows, frames, f1, f2, d, chunk, windows_per_block);
  return static_cast<int>(cudaGetLastError());
}
