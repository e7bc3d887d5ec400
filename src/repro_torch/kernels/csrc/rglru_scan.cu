// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, Hopper sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py: rglru_scan (body
// _kernel, a chunk of the sequence per grid step with the carry in VMEM
// scratch). Same contract: a, b (B,S,W) float32 or bfloat16, cast to float32
// as the Pallas kernel casts them; the carry is float32 and starts from zero;
// h (B,S,W) float32, the state after every step. Unlike the Pallas kernel it
// takes any S >= 1 (no multiple of a chunk).
//
// What bounds it on the card: bytes. Each element costs one FMA against 12
// bytes of traffic in float32 (a and b read, h written), far below the
// ~20 flops per byte at which the float32 units would be the limit. The
// recurrence is sequential in t, though, and the serving path runs it at
// batch 1: one thread per (batch, channel) is only 32 CTAs of 128 threads
// for W 4096 on 132 SMs, each thread a chain of S dependent loads and FMAs,
// so such a kernel is bound by the latency of its loads, not by the rate of
// the memory. The design splits the sequence as well:
//   * a CTA holds 32 channels (one warp-wide, coalesced 128-byte row of a
//     float32 tile) and up to 32 warps, warp k owning the k-th of nchunk
//     consecutive chunks of the sequence; at B 1, W 4096 that is 128 CTAs;
//   * pass 1: each thread scans its chunk from zero and keeps only the
//     chunk's end state and the product of its a's (a product that
//     underflows to 0 is harmless: its carry no longer matters);
//   * one warp combines the chunk ends in order through shared memory,
//     giving each chunk its carry-in: carry_k = end_{k-1} + prod_{k-1} *
//     carry_{k-1};
//   * pass 2: each thread runs the plain recurrence over its chunk again,
//     from its carry-in, and writes h. Within a chunk the arithmetic is the
//     plain version's; only the carry is summed in another order.
// So a and b are read twice (the second time partly from L2) and h written
// once: at most 5/3 of the bound's traffic, with nchunk independent chains
// per channel in flight instead of one. The step loops are unrolled so the
// loads of a and b run several steps ahead of the FMA chain.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 32;   // channels per CTA: one per lane
constexpr int kMaxChunks = 32;  // warps per CTA

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kChannels * kMaxChunks)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  float* __restrict__ h, int s, int w, int chunk_len) {
  __shared__ float end_s[kMaxChunks][kChannels];
  __shared__ float prod_s[kMaxChunks][kChannels];

  const int lane = threadIdx.x % kChannels;
  const int k = threadIdx.x / kChannels;          // this warp's chunk
  const int nchunk = blockDim.x / kChannels;
  const int c = blockIdx.x * kChannels + lane;    // channel
  const int bb = blockIdx.y;                      // batch row
  const bool active = c < w;
  const int t0 = min(k * chunk_len, s);
  const int t1 = min(t0 + chunk_len, s);
  const size_t base = (size_t)bb * s * w + c;

  // pass 1: the chunk from zero, and the product of its decays
  float hl = 0.f, pl = 1.f;
  if (active) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      const float at = to_f32(a[base + (size_t)t * w]);
      const float bt = to_f32(b[base + (size_t)t * w]);
      hl = fmaf(at, hl, bt);
      pl *= at;
    }
  }
  end_s[k][lane] = hl;
  prod_s[k][lane] = pl;
  __syncthreads();

  // chunk carries, in order; end_s[j] becomes chunk j's carry-in
  if (k == 0) {
    float carry = 0.f;
    for (int j = 0; j < nchunk; ++j) {
      const float e = end_s[j][lane], p = prod_s[j][lane];
      end_s[j][lane] = carry;
      carry = fmaf(p, carry, e);
    }
  }
  __syncthreads();

  // pass 2: the plain recurrence from the carry-in, writing every step
  if (active) {
    float hh = end_s[k][lane];
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      const float at = to_f32(a[base + (size_t)t * w]);
      const float bt = to_f32(b[base + (size_t)t * w]);
      hh = fmaf(at, hh, bt);
      h[base + (size_t)t * w] = hh;
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, float* h, int bsz, int s, int w,
           int nchunk, cudaStream_t st) {
  const int chunk_len = (s + nchunk - 1) / nchunk;
  const dim3 grid((w + kChannels - 1) / kChannels, bsz);
  rglru_scan_kernel<T><<<grid, kChannels * nchunk, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h, s, w, chunk_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry. The wrapper (repro_torch/kernels/rglru_scan.py) has checked
// shapes, dtypes (a and b share float32 or bfloat16), contiguity, S >= 1 and
// 1 <= nchunk <= 32. Returns the cudaError_t of the launch.
extern "C" int rglru_scan(const void* a, const void* b, void* h, int bsz, int s,
                          int w, int nchunk, int is_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto out = static_cast<float*>(h);
  if (nchunk < 1 || nchunk > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) return launch<__nv_bfloat16>(a, b, out, bsz, s, w, nchunk, st);
  return launch<float>(a, b, out, bsz, s, w, nchunk, st);
}
