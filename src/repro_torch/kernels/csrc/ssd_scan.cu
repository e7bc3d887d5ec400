// Mamba-2 SSD chunk scan for Hopper (sm_90a), float32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (Pallas,
// grid (B, H, chunks) with the chunk axis sequential and the (P, N) state in
// VMEM scratch). It computes what src/repro/models/ssm.py::ssd_chunked
// computes: y, the final state, and optionally the state after every chunk,
// starting from an optional initial state (zeros when it is null). With a
// zero initial state and no per-chunk states it is exactly the Pallas
// kernel's function.
//
//   x    (B, S, H, P)  dt-scaled inputs        dt_a (B, S, H)  A * dt
//   b, c (B, S, N)     shared by all heads     init (B, H, P, N) or null
//   y    (B, S, H, P)  final_state (B, H, P, N)
//   all_states (B, S/L, H, P, N) or null: the state after each chunk
//
// Design. Hopper's CTAs run in no order, so the Pallas grid's sequential
// chunk axis becomes a loop over the chunks inside one CTA, and the carried
// state lives in shared memory for the whole sequence. A CTA owns one
// (batch, head) pair and PS rows of its (P, N) state: the rows evolve
// independently, so the wrapper splits P until the CTAs fill one wave of
// SMs (at batch 1, 64 heads alone would leave 68 of 132 SMs idle; the
// split gives 128 CTAs of 32 rows each). Per chunk of L <= 64 tokens:
//   1. B, C and this CTA's x slice are staged into shared memory; one warp
//      scans dt_a into the cumulative decay a_cum by shuffles;
//   2. scores[s][t] = C_s . B_t * exp(a_cum[s] - a_cum[t]) for t <= s, each
//      thread a 4 x 4 register tile, the tiles above the diagonal skipped;
//   3. y[s] = sum_t scores[s][t] x_t + exp(a_cum[s]) * C_s . state;
//   4. state = state * exp(a_cum[L-1]) + sum_t exp(a_cum[L-1] - a_cum[t])
//      x_t B_t^T, written out after the chunk when asked, and at the end.
// Shared rows are padded to an odd stride, so the column walks of stages 2
// and 3 hit distinct banks.
//
// What bounds it. At the serve's span shape (B 1, S 128, H 64, P 64, N 128,
// L 64, initial state in, per-chunk states out) the scan needs about 0.37
// GFLOP against about 12 MB of traffic: 5.5 us of float32 operations at 67
// TFLOP/s against 3.7 us of bytes at 3.35 TB/s, so operations bound it. The
// math stays on the float32 FMA units: TF32 tensor cores keep 10 mantissa
// bits, too few for the 2e-4 contract. This first version stays far from
// that bound: at 217 registers a thread one CTA of 8 warps fits on an SM,
// too few to hide shared-memory latency, and the register tiles are sized
// for the largest P slice and chunk, so smaller ones run predicated-off
// work. Each split of P also recomputes the chunk's C . B^T (shared by all
// heads, ngroups = 1). More warps per SM, tiles fixed at compile time,
// sharing C . B^T across the CTAs of a chunk, or 3xTF32 on the tensor
// cores, are later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 64;    // chunk length
constexpr int kMaxN = 128;   // state size
constexpr int kMaxPS = 64;   // state rows per CTA

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt_a,
                const float* __restrict__ b_g, const float* __restrict__ c_g,
                const float* __restrict__ init, float* __restrict__ y,
                float* __restrict__ final_state, float* __restrict__ all_states,
                int S, int H, int P, int N, int L, int PS) {
  extern __shared__ float smem[];
  const int LP = (L + 15) / 16 * 16;   // chunk rows, padded with zeros
  const int NS = N + 1;                // padded stride of B, C and state rows
  const int SS = LP + 1;               // padded stride of the score rows
  float* st = smem;                    // [PS][NS] carried state rows
  float* bsm = st + PS * NS;           // [LP][NS] B rows of the chunk
  float* csm = bsm + LP * NS;          // [LP][NS] C rows of the chunk
  float* xsm = csm + LP * NS;          // [LP][PS] x rows, this CTA's columns
  float* sc = xsm + LP * PS;           // [LP][SS] decayed, masked C . B^T
  float* acum = sc + LP * SS;          // [LP] cumulative dt_a
  float* dec = acum + LP;              // [LP] exp(a_cum[L-1] - a_cum[t])

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int nc = S / L;
  const size_t bh = (size_t)b * H + h;

  for (int i = tid; i < PS * N; i += kThreads) {
    const int j = i / N, n = i % N;
    st[j * NS + n] = init ? init[(bh * P + p0 + j) * N + n] : 0.f;
  }

  for (int ci = 0; ci < nc; ++ci) {
    const size_t t0 = (size_t)b * S + (size_t)ci * L;   // (b, first token)
    __syncthreads();   // the previous chunk is done with the tiles
    // ---- 1. stage the chunk; scan dt_a
    for (int i = tid; i < LP * N; i += kThreads) {
      const int l = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (l < L) {
        bv = b_g[(t0 + l) * N + n];
        cv = c_g[(t0 + l) * N + n];
      }
      bsm[l * NS + n] = bv;
      csm[l * NS + n] = cv;
    }
    for (int i = tid; i < LP * PS; i += kThreads) {
      const int l = i / PS, j = i % PS;
      xsm[i] = l < L ? x[((t0 + l) * H + h) * P + p0 + j] : 0.f;
    }
    if (warp == 0) {
      // lane holds rows lane and lane + 32; padded rows add 0, so they carry
      // a_cum[L-1] and contribute nothing (their B, C and x are 0)
      float v0 = lane < L ? dt_a[(t0 + lane) * H + h] : 0.f;
      float v1 = lane + 32 < L ? dt_a[(t0 + lane + 32) * H + h] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, o);
        if (lane >= o) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float total = L <= 32 ? __shfl_sync(0xffffffffu, v0, L - 1)
                                  : __shfl_sync(0xffffffffu, v1, L - 33);
      if (lane < LP) {
        acum[lane] = v0;
        dec[lane] = expf(total - v0);
      }
      if (lane + 32 < LP) {
        acum[lane + 32] = v1;
        dec[lane + 32] = expf(total - v1);
      }
    }
    __syncthreads();

    // ---- 2. scores: thread (si, ti) holds rows si + 16r, columns ti + 16c
    {
      const int si = tid >> 4, ti = tid & 15, R = LP >> 4;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          cv[r] = r < R ? csm[(si + 16 * r) * NS + n] : 0.f;
          bv[r] = r < R ? bsm[(ti + 16 * r) * NS + n] : 0.f;
        }
        // column tile c > r lies wholly above the diagonal (t > s)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c <= r; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (r < R && c < R) {
            const int s = si + 16 * r, t = ti + 16 * c;
            sc[s * SS + t] = (t <= s && s < L)
                                 ? acc[r][c] * expf(acum[s] - acum[t]) : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // ---- 3. y: thread (p, sg) holds rows s = sg + SG k of column p
    {
      const int p = tid % PS, sg = tid / PS, SG = kThreads / PS;
      float yi[16], yo[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) yi[k] = yo[k] = 0.f;
      for (int t = 0; t < L; ++t) {
        const float xv = xsm[t * PS + p];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int s = sg + SG * k;
          if (s < L) yi[k] = fmaf(sc[s * SS + t], xv, yi[k]);
        }
      }
      for (int n = 0; n < N; ++n) {
        const float sv = st[p * NS + n];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int s = sg + SG * k;
          if (s < L) yo[k] = fmaf(csm[s * NS + n], sv, yo[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int s = sg + SG * k;
        if (s < L) y[((t0 + s) * H + h) * P + p0 + p] = yi[k] + expf(acum[s]) * yo[k];
      }
    }
    __syncthreads();   // stage 3 has read the state

    // ---- 4. state update: thread holds rows warp + 8k, columns lane + 32m
    {
      const float chunk_decay = expf(acum[L - 1]);
      float acc[8][4];
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[k][m] = 0.f;
      for (int t = 0; t < L; ++t) {
        const float d = dec[t];
        float bv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int n = lane + 32 * m;
          bv[m] = n < N ? bsm[t * NS + n] * d : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = warp + kWarps * k;
          const float xv = j < PS ? xsm[t * PS + j] : 0.f;
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[k][m] = fmaf(xv, bv[m], acc[k][m]);
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = warp + kWarps * k;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int n = lane + 32 * m;
          if (j < PS && n < N) {
            const float v = st[j * NS + n] * chunk_decay + acc[k][m];
            st[j * NS + n] = v;
            if (all_states)
              all_states[((((size_t)b * nc + ci) * H + h) * P + p0 + j) * N + n] = v;
            if (ci == nc - 1) final_state[(bh * P + p0 + j) * N + n] = v;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int ssd_scan(const float* x, const float* dt_a, const float* b,
                        const float* c, const float* init, float* y,
                        float* final_state, float* all_states, int B, int S,
                        int H, int P, int N, int L, int PS, void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > kMaxL || N < 1 || N > kMaxN || PS < 1 ||
      PS > kMaxPS || P % PS || kThreads % PS || S < L || S % L)
    return (int)cudaErrorInvalidValue;
  const int LP = (L + 15) / 16 * 16;
  const size_t smem = sizeof(float) * ((size_t)PS * (N + 1) + 2 * (size_t)LP * (N + 1) +
                                       (size_t)LP * PS + (size_t)LP * (LP + 1) + 2 * LP);
  // above 48 KB only after opting in; the largest tile set is 132 KB
  static size_t opted_in = 0;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const dim3 grid(P / PS, H, B);
  ssd_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, dt_a, b, c, init, y, final_state, all_states, S, H, P, N, L, PS);
  return (int)cudaGetLastError();
}
