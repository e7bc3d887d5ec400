// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, Hopper sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py: rglru_scan (body
// _kernel, a chunk of the sequence per grid step with the carry in VMEM
// scratch, each tile of a and b read from HBM once). Same contract: a, b
// (B,S,W) float32 or bfloat16, cast to float32 as the Pallas kernel casts
// them; the carry is float32 and starts from zero; h (B,S,W) float32, the
// state after every step. Unlike the Pallas kernel it takes any S >= 1 (no
// multiple of a chunk).
//
// What bounds it on the card: bytes. Each element costs one FMA against 12
// bytes of traffic in float32 (a and b read, h written), far below the
// ~20 flops per byte at which the float32 units would be the limit. Two
// things keep a kernel from that bound. The recurrence is sequential in t,
// and the serving path runs it at batch 1, so a thread per channel walking
// its chain from device memory waits on one load after another; and a
// kernel that splits the sequence and reads a and b twice (once for the
// chunk ends, once for h) moves 5/3 of the bytes, the second read from DRAM
// once a and b outgrow L2. The design:
//   * a CTA owns 32 channels (one lane each; a 128-byte row of a float32
//     tile, 64 bytes of a bfloat16 one) of one batch row and streams the
//     whole sequence once, slab by slab: a slab is `rows` steps of a and b,
//     copied into shared memory by 16-byte cp.async, the whole slab asked
//     for at once. Slabs go round a ring of two buffers, the next slab in
//     flight while one is scanned (a third buffer measured no faster); at
//     S 128 one slab holds everything and the ring is one buffer. a and b
//     stay in their type in shared memory and are widened as they are read.
//     At B 1, W 4096 that is 128 CTAs;
//   * the slab's steps are split among the 16 warps, warp k owning the k-th
//     sub-chunk of rows / 16 consecutive steps, lane = channel, so a warp
//     reads one row of the tile at a time, free of bank conflicts;
//   * pass 1: each thread scans its sub-chunk from zero, keeping only the
//     end state and the product of its a's (a product that underflows to 0
//     is harmless: its carry no longer matters);
//   * the 16 sub-chunks' affine maps (p, e) of a channel are combined by a
//     log-depth scan in shuffles, (p2 p1, p2 e1 + e2), half a warp a
//     channel, the carry from the previous slab entering first; this gives
//     each sub-chunk its carry-in and the next slab its carry;
//   * pass 2: each thread runs the plain recurrence over its sub-chunk again
//     from its carry-in, out of shared memory, and stores h; a warp stores a
//     whole 128-byte row of h at a time.
// Within a sub-chunk the arithmetic is the plain version's; only the carry
// is summed in another order. Device-memory traffic is the bound's count:
// a and b read once, h written once. A ragged last tile of channels and a
// ragged last slab are masked here; the wrapper checks the alignment the
// 16-byte copies need (16-byte aligned operands, rows a multiple of 16
// bytes).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_ptx.cuh"

namespace {

constexpr int kChannels = 32;                 // channels per CTA: one per lane
constexpr int kWarps = 16;                    // sub-chunks of a slab: one per warp
constexpr int kThreads = kChannels * kWarps;
constexpr int kMaxStages = 2;
constexpr int kSmemLimit = 232448;            // shared memory a CTA may use
// (p, e) of every sub-chunk and channel; the row pad keeps the combine's
// column reads on distinct banks
constexpr int kStaticSmem = 2 * kWarps * (kChannels + 1) * 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rglru_ring_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  float* __restrict__ h, int s, int w, int rows, int stages) {
  extern __shared__ __align__(16) unsigned char ring_raw[];
  __shared__ float prod_s[kWarps][kChannels + 1];
  __shared__ float end_s[kWarps][kChannels + 1];   // then each sub-chunk's carry-in

  constexpr int kPerCopy = 16 / sizeof(T);         // elements of one 16-byte copy
  constexpr int kCopiesPerRow = kChannels / kPerCopy;
  T* const ring = reinterpret_cast<T*>(ring_raw);
  const size_t slab = (size_t)rows * kChannels;    // elements of a (or b) a slab
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = blockIdx.x * kChannels;
  const size_t row0 = (size_t)blockIdx.y * s;      // this batch row's first step
  const int nslab = (s + rows - 1) / rows;
  const int sub = rows / kWarps;                   // steps of a sub-chunk

  // ask for slab k (if any) into its stage; one copy group per call, empty
  // past the end, so the group count stays uniform
  auto issue = [&](int k) {
    if (k < nslab) {
      const int t0 = k * rows, nrow = min(rows, s - t0);
      T* const dst = ring + (size_t)(k % stages) * 2 * slab;
      const int per = nrow * kCopiesPerRow;
      for (int i = threadIdx.x; i < 2 * per; i += kThreads) {
        const int arr = i >= per, j = i - arr * per;
        const int r = j / kCopiesPerRow, col = (j % kCopiesPerRow) * kPerCopy;
        if (c0 + col < w)                          // the wrapper keeps W % kPerCopy == 0
          ptx::cp_async16(ptx::smem_u32(dst + arr * slab + r * kChannels + col),
                          (arr ? b : a) + (row0 + t0 + r) * w + c0 + col, 16);
      }
    }
    ptx::cp_commit();
  };

  for (int k = 0; k < stages - 1; ++k) issue(k);
  // the combine's channel and sub-chunk: half a warp a channel
  const int cj = lane % kWarps, cch = warp * 2 + lane / kWarps;
  float carry = 0.f;                               // channel cch's state before the slab
  const bool live = c0 + lane < w;
  for (int k = 0; k < nslab; ++k) {
    issue(k + stages - 1);
    if (stages == 2)                               // slab k landed, k + 1 may be in flight
      ptx::cp_wait<1>();
    else
      ptx::cp_wait<0>();
    __syncthreads();
    const T* const sa = ring + (size_t)(k % stages) * 2 * slab;
    const T* const sb = sa + slab;
    const int t0 = k * rows, nrow = min(rows, s - t0);
    const int r0 = warp * sub, r1 = min(r0 + sub, nrow);

    // pass 1: the sub-chunk from zero, and the product of its decays
    float e = 0.f, p = 1.f;
#pragma unroll 8
    for (int r = r0; r < r1; ++r) {
      const float at = to_f32(sa[r * kChannels + lane]);
      e = fmaf(at, e, to_f32(sb[r * kChannels + lane]));
      p *= at;
    }
    prod_s[warp][lane] = p;
    end_s[warp][lane] = e;
    __syncthreads();

    // combine: an inclusive scan of the 16 sub-chunks' maps of channel
    // cch, the carry folded into the first; end_s becomes the carry-ins
    float pj = prod_s[cj][cch], ej = end_s[cj][cch];
    if (cj == 0) ej = fmaf(pj, carry, ej);
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const float pu = __shfl_up_sync(0xffffffffu, pj, d, kWarps);
      const float eu = __shfl_up_sync(0xffffffffu, ej, d, kWarps);
      if (cj >= d) {
        ej = fmaf(pj, eu, ej);
        pj *= pu;
      }
    }
    const float cin = __shfl_up_sync(0xffffffffu, ej, 1, kWarps);
    end_s[cj][cch] = cj == 0 ? carry : cin;
    carry = __shfl_sync(0xffffffffu, ej, kWarps - 1, kWarps);
    __syncthreads();

    // pass 2: the plain recurrence from the carry-in, storing every step
    if (live) {
      float hh = end_s[warp][lane];
      float* const out = h + (row0 + t0) * w + c0 + lane;
#pragma unroll 8
      for (int r = r0; r < r1; ++r) {
        hh = fmaf(to_f32(sa[r * kChannels + lane]), hh, to_f32(sb[r * kChannels + lane]));
        out[(size_t)r * w] = hh;
      }
    }
    __syncthreads();                               // the stage and end_s are free again
  }
}

// the same grid, block and shared memory doing nothing: the launch floor
__global__ void __launch_bounds__(kThreads, 2) rglru_empty_kernel() {}

template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  static int allowed = 48 << 10;                   // per kernel
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit - kStaticSmem);
  if (e == cudaSuccess) allowed = kSmemLimit - kStaticSmem;
  return e;
}

template <typename T>
int launch(const void* a, const void* b, float* h, int bsz, int s, int w, int rows,
           int stages, int smem, cudaStream_t st) {
  const cudaError_t e = allow_smem(rglru_ring_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((w + kChannels - 1) / kChannels, bsz);
  rglru_ring_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h, s, w, rows, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry. The wrapper (repro_torch/kernels/rglru_scan.py) has checked
// shapes, dtypes (a and b share float32 or bfloat16), contiguity, 16-byte
// alignment of a, b and their rows, and S >= 1, and its rglru_plan gives
// the slab rows (a multiple of 16), the ring stages (1 or 2) and the
// dynamic shared memory, stages * 2 * rows * 32 elements. Returns the
// cudaError_t of the launch.
extern "C" int rglru_scan(const void* a, const void* b, void* h, int bsz, int s,
                          int w, int rows, int stages, int smem, int is_bf16,
                          void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto out = static_cast<float*>(h);
  const int elem = is_bf16 ? 2 : 4;
  if (rows < kWarps || rows % kWarps || stages < 1 || stages > kMaxStages ||
      smem < stages * 2 * rows * kChannels * elem || smem > kSmemLimit - kStaticSmem)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) return launch<__nv_bfloat16>(a, b, out, bsz, s, w, rows, stages, smem, st);
  return launch<float>(a, b, out, bsz, s, w, rows, stages, smem, st);
}

// An empty kernel on the grid, block and dynamic shared memory of a scan
// launch: what a launch costs before it moves a byte.
extern "C" int rglru_empty(int bsz, int w, int smem, void* stream) {
  if (smem < 0 || smem > kSmemLimit - kStaticSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(rglru_empty_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((w + kChannels - 1) / kChannels, bsz);
  rglru_empty_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
