// Backward of the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t,
// Hopper sm_90a.
//
// Port-only: the JAX package differentiates its XLA associative scan
// (src/repro/models/rglru.py:66) and has no Pallas backward; the port's
// forward is a kernel (rglru_scan.cu), whose output carries no autograd
// graph, so its gradient is a kernel too. Given a
// (B,S,W) float32 or bfloat16, the forward's h (B,S,W) float32 and g = dL/dh
// (B,S,W) float32, it writes da and db (B,S,W) in a's type:
//   lam_{S-1} = g_{S-1},  lam_t = g_t + a_{t+1} lam_{t+1}
//   db_t = lam_t,         da_t = lam_t h_{t-1}   (h_{-1} = 0)
// In mu_t = a_t lam_t the walk is the forward's recurrence run backwards in
// time: lam_t = g_t + mu_{t+1}, mu_t = a_t lam_t.
//
// What bounds it on the card: bytes, as for the forward. Each element costs
// two FMAs against 20 bytes of traffic in float32 (a, h and g read, da and db
// written). The design is the forward's, walking time backwards:
//   * a CTA owns 32 channels (one lane each) of one batch row and streams the
//     whole sequence once, last slab first. A slab is `rows` steps of a, g and
//     h shifted one step back (row r holds h_{t0+r-1}; the first slab's row 0
//     is zero-filled), copied into shared memory by 16-byte cp.async; slabs
//     go round a ring of two buffers, the earlier slab in flight while one is
//     walked;
//   * the slab's steps are split among the 16 warps, warp k owning the k-th
//     sub-chunk of rows / 16 consecutive steps, lane = channel;
//   * pass 1: each thread walks its sub-chunk backwards from mu = 0, keeping
//     its end value and the product of its a's;
//   * the 16 sub-chunks' affine maps of a channel are combined by a log-depth
//     shuffle scan taken from the last sub-chunk to the first, the carry from
//     the later slab entering first; this gives each sub-chunk its carry-in
//     and the earlier slab its carry;
//   * pass 2: each thread walks its sub-chunk backwards again from its
//     carry-in, out of shared memory, and stores da and db.
// Device-memory traffic is the bound's count but for the one row of h a slab
// reads again. The wrapper checks the alignment the 16-byte copies need
// (16-byte aligned operands, rows a multiple of 16 bytes).

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
constexpr int kStaticSmem = 2 * kWarps * (kChannels + 1) * 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rglru_bwd_ring_kernel(const T* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ g, T* __restrict__ da,
                      T* __restrict__ db, int s, int w, int rows, int stages) {
  extern __shared__ __align__(16) unsigned char ring_raw[];
  __shared__ float prod_s[kWarps][kChannels + 1];
  __shared__ float end_s[kWarps][kChannels + 1];   // then each sub-chunk's carry-in

  // a stage: a (rows x 32 of T), then g and the shifted h (rows x 32 float each)
  const size_t slab = (size_t)rows * kChannels;
  const size_t stage_bytes = slab * (sizeof(T) + 8);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = blockIdx.x * kChannels;
  const size_t row0 = (size_t)blockIdx.y * s;
  const int nslab = (s + rows - 1) / rows;
  const int sub = rows / kWarps;
  constexpr int kPerA = 16 / sizeof(T);            // a elements of one 16-byte copy
  constexpr int kCopiesA = kChannels / kPerA, kCopiesF = kChannels / 4;

  // ask for the i-th slab walked (slab nslab - 1 - i) into stage i % stages;
  // one copy group per call, empty past the end
  auto fetch = [&](int i) {
    if (i < nslab) {
      const int k = nslab - 1 - i;
      const int t0 = k * rows, nrow = min(rows, s - t0);
      unsigned char* const st = ring_raw + (size_t)(i % stages) * stage_bytes;
      T* const sa = reinterpret_cast<T*>(st);
      float* const sg = reinterpret_cast<float*>(st + slab * sizeof(T));
      float* const sh = sg + slab;
      const int na = nrow * kCopiesA, nf = nrow * kCopiesF;
      for (int j = threadIdx.x; j < na + 2 * nf; j += kThreads) {
        if (j < na) {
          const int r = j / kCopiesA, col = (j % kCopiesA) * kPerA;
          if (c0 + col < w)
            ptx::cp_async16(ptx::smem_u32(sa + r * kChannels + col),
                            a + (row0 + t0 + r) * w + c0 + col, 16);
        } else {
          const int jj = j - na, arr = jj >= nf, q = jj - arr * nf;
          const int r = q / kCopiesF, col = (q % kCopiesF) * 4;
          if (c0 + col >= w) continue;
          float* const dst = (arr ? sh : sg) + r * kChannels + col;
          if (!arr) {
            ptx::cp_async16(ptx::smem_u32(dst), g + (row0 + t0 + r) * w + c0 + col, 16);
          } else {
            const bool first = t0 + r == 0;      // h_{-1} = 0: zero-fill
            ptx::cp_async16(ptx::smem_u32(dst),
                            h + (row0 + t0 + r - (first ? 0 : 1)) * w + c0 + col,
                            first ? 0 : 16);
          }
        }
      }
    }
    ptx::cp_commit();
  };

  for (int i = 0; i < stages - 1; ++i) fetch(i);
  const int cj = lane % kWarps, cch = warp * 2 + lane / kWarps;
  const int csub = kWarps - 1 - cj;                // the combine walks sub-chunks last first
  float carry = 0.f;                               // mu entering the slab from later steps
  const bool live = c0 + lane < w;
  for (int i = 0; i < nslab; ++i) {
    fetch(i + stages - 1);
    if (stages == 2)
      ptx::cp_wait<1>();
    else
      ptx::cp_wait<0>();
    __syncthreads();
    const unsigned char* const st = ring_raw + (size_t)(i % stages) * stage_bytes;
    const T* const sa = reinterpret_cast<const T*>(st);
    const float* const sg = reinterpret_cast<const float*>(st + slab * sizeof(T));
    const float* const sh = sg + slab;
    const int k = nslab - 1 - i;
    const int t0 = k * rows, nrow = min(rows, s - t0);
    const int r0 = warp * sub, r1 = min(r0 + sub, nrow);

    // pass 1: the sub-chunk backwards from mu = 0, and the product of its a's
    float e = 0.f, p = 1.f;
#pragma unroll 8
    for (int r = r1 - 1; r >= r0; --r) {
      const float at = to_f32(sa[r * kChannels + lane]);
      e = at * (sg[r * kChannels + lane] + e);
      p *= at;
    }
    prod_s[warp][lane] = p;
    end_s[warp][lane] = e;
    __syncthreads();

    // combine: an inclusive scan of the sub-chunks' maps of channel cch from
    // the last sub-chunk to the first, the carry folded into the last
    float pj = prod_s[csub][cch], ej = end_s[csub][cch];
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
    end_s[csub][cch] = cj == 0 ? carry : cin;
    carry = __shfl_sync(0xffffffffu, ej, kWarps - 1, kWarps);
    __syncthreads();

    // pass 2: the walk from the carry-in, storing da and db at every step
    if (live) {
      float mu = end_s[warp][lane];
      const size_t base = (row0 + t0) * w + c0 + lane;
#pragma unroll 8
      for (int r = r1 - 1; r >= r0; --r) {
        const float lam = sg[r * kChannels + lane] + mu;
        store(db + base + (size_t)r * w, lam);
        store(da + base + (size_t)r * w, lam * sh[r * kChannels + lane]);
        mu = to_f32(sa[r * kChannels + lane]) * lam;
      }
    }
    __syncthreads();                               // the stage and end_s are free again
  }
}

template <typename T>
int launch(const void* a, const float* h, const float* g, void* da, void* db, int bsz,
           int s, int w, int rows, int stages, int smem, cudaStream_t st) {
  static bool allowed = false;                     // per instantiation: the
  if (!allowed) {                                  // static arrays count too
    const cudaError_t e = cudaFuncSetAttribute(
        rglru_bwd_ring_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit - kStaticSmem);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  const dim3 grid((w + kChannels - 1) / kChannels, bsz);
  rglru_bwd_ring_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a), h, g, static_cast<T*>(da), static_cast<T*>(db), s, w,
      rows, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry. The wrapper (repro_torch/kernels/rglru_scan.py) has checked
// shapes, dtypes (a float32 or bfloat16; h and g float32; da and db in a's
// type), contiguity, 16-byte alignment of every operand and its rows, and
// S >= 1; its rglru_bwd_plan gives the slab rows (a multiple of 16), the
// ring stages (1 or 2) and the dynamic shared memory,
// stages * rows * 32 * (a's element size + 8). Returns the cudaError_t of
// the launch.
extern "C" int rglru_scan_bwd(const void* a, const void* h, const void* g, void* da,
                              void* db, int bsz, int s, int w, int rows, int stages,
                              int smem, int is_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int elem = is_bf16 ? 2 : 4;
  if (rows < kWarps || rows % kWarps || stages < 1 || stages > kMaxStages ||
      smem < stages * rows * kChannels * (elem + 8) || smem > kSmemLimit - kStaticSmem)
    return (int)cudaErrorInvalidValue;
  const auto hf = static_cast<const float*>(h);
  const auto gf = static_cast<const float*>(g);
  if (is_bf16)
    return launch<__nv_bfloat16>(a, hf, gf, da, db, bsz, s, w, rows, stages, smem, st);
  return launch<float>(a, hf, gf, da, db, bsz, s, w, rows, stages, smem, st);
}
