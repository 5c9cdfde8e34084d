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
// float32 (fused_cca_decode_kernel), the per-chunk serving shape (T = 1,
// 32 frames a chunk). Each block stages rot1 and rot2, transposed to
// [D, F] fp32, in dynamic shared memory once (102 KB at F1 = 2553, D = 10),
// then walks a contiguous range of windows; a warp takes kRows consecutive
// rows (frames) at a time, its lanes stride F with coalesced loads, and
// each lane keeps kRows x D fp32 partial dot products in registers, so one
// shared-memory read of rot[d, f] feeds kRows fused multiply-adds; a
// butterfly warp reduction finishes them, lane 0 scores the rows and adds
// each score to its window's per-warp partial sum in shared memory, summed
// in a fixed order after a barrier. D is a template parameter (1..16) so
// the accumulators stay in registers. At the serving shape its time is
// launch latency and the host's work around the call (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;

// Projects rows row0 .. row0 + kRows - 1 of x [*, f] onto rot_t [D, f]
// (shared memory). Rows at or past last_row re-read last_row, so every
// load stays in bounds; the caller ignores their results. On return every
// lane holds the full sums.
template <int D>
__device__ __forceinline__ void project_rows(const float* __restrict__ x,
                                             long long row0,
                                             long long last_row, int f,
                                             const float* rot_t, int lane,
                                             float (&acc)[kRows][D]) {
  const float* rows[kRows];
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
    for (int r = 0; r < kRows; ++r) xv[r] = rows[r][j];
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
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
fused_cca_decode_kernel(const float* __restrict__ x1,
                        const float* __restrict__ x2a,
                        const float* __restrict__ x2b,
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
    project_rows<D>(x1, row0, row_end - 1, f1, s_rot1, lane, r1);
    project_rows<D>(x2a, row0, row_end - 1, f2, s_rot2, lane, r2);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (row0 + r < row_end) {
          my_part_a[(row0 + r) / frames - w0] += score_row<D>(r1[r], r2[r], consts);
        }
      }
    }
    if (pair) {
      project_rows<D>(x2b, row0, row_end - 1, f2, s_rot2, lane, r2);
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

template <int D>
cudaError_t launch(const float* x1, const float* x2a, const float* x2b,
                   const float* rot1_t, const float* rot2_t,
                   const float* consts, float* out_a, float* out_b,
                   int windows, int frames, int f1, int f2,
                   int windows_per_block, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (3 * D + 1 + static_cast<size_t>(D) * (f1 + f2) +
       2 * kWarps * static_cast<size_t>(windows_per_block));
  auto kernel = fused_cca_decode_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (windows + windows_per_block - 1) / windows_per_block;
  kernel<<<blocks, kThreads, smem, stream>>>(
      x1, x2a, x2b, rot1_t, rot2_t, consts, out_a, out_b, windows, frames,
      f1, f2, windows_per_block);
  return cudaGetLastError();
}

}  // namespace

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

// float32 windows. x2b and out_b are null for the single-stream form.
// consts holds c1 [d], c2 [d], scale [d] and the intercept; rot1_t [d, f1]
// and rot2_t [d, f2].
extern "C" int tdt_fused_cca_decode(const float* x1, const float* x2a,
                                    const float* x2b, const float* rot1_t,
                                    const float* rot2_t, const float* consts,
                                    float* out_a, float* out_b, int windows,
                                    int frames, int f1, int f2, int d,
                                    int windows_per_block, void* stream) {
  if (windows <= 0 || frames <= 0 || windows_per_block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define TDT_DIMS_CASE(N)                                                   \
  case N:                                                                  \
    return static_cast<int>(launch<N>(x1, x2a, x2b, rot1_t, rot2_t, consts, \
                                      out_a, out_b, windows, frames, f1,   \
                                      f2, windows_per_block, s));
    TDT_DIMS_CASE(1) TDT_DIMS_CASE(2) TDT_DIMS_CASE(3) TDT_DIMS_CASE(4)
    TDT_DIMS_CASE(5) TDT_DIMS_CASE(6) TDT_DIMS_CASE(7) TDT_DIMS_CASE(8)
    TDT_DIMS_CASE(9) TDT_DIMS_CASE(10) TDT_DIMS_CASE(11) TDT_DIMS_CASE(12)
    TDT_DIMS_CASE(13) TDT_DIMS_CASE(14) TDT_DIMS_CASE(15) TDT_DIMS_CASE(16)
#undef TDT_DIMS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
