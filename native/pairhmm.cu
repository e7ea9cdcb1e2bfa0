// Batched 5-state pair-HMM posteriors + MEA (EA) scores for Hopper,
// called from JAX through the XLA foreign function interface.
//
// Same recurrences, parameter tables and operation order as the XLA
// antidiagonal formulation in dna_ldpc_tpu/ops/msa/pairhmm.py
// (_posteriors_device + _mea_scores), which is the reference this kernel
// is compared with:
//
//   1. forward sweep over antidiagonals d = i + j with the natural
//      sequences; the M-state value of every cell inside the pair's
//      (lx, ly) rectangle is parked in the posterior output, and the
//      corner states give the total probability;
//   2. the W-DP over the REVERSED sequences with the transposed
//      transition table (the same step function), folded through
//      trans[M][:] into the backward M-plane; each reversed cell (a, b)
//      is natural cell (lx - a, ly - b), whose parked forward value turns
//      into the sparsified posterior exp(F + B - total) in place;
//   3. the MEA max-DP (CalcAlnScoreFlat) over the bf16-rounded
//      posteriors, so only the posterior and one score per pair leave.
//
// Layout: one thread block per pair, one thread per DP row i; the two
// previous antidiagonals live in shared memory, so the one-cell shift
// (row i - 1) is a shared-memory read.
//
// Build (compute capability 9.0a):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> -o build/libpairhmm.so \
//        native/pairhmm.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kLogZero = -1e30f;
constexpr float kMinSparseProb = 0.01f;
constexpr int kStates = 5;  // M, IX, IY, JX, JY (START is implicit)
enum { M = 0, IX = 1, IY = 2, JX = 3, JY = 4 };

// params: start[5] | trans6[6][5] | trans_rev[6][5] | match[5][5] | ins[5]
constexpr int kStart = 0, kTrans = 5, kTransRev = 35, kMatch = 65, kIns = 90;
constexpr int kParams = 95;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  float m = fmaxf(fmaxf(a, b), c);
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__device__ __forceinline__ float lse5(const float* t) {
  float m = t[0];
  for (int k = 1; k < 5; ++k) m = fmaxf(m, t[k]);
  float s = 0.0f;
  for (int k = 0; k < 5; ++k) s += expf(t[k] - m);
  return m + logf(s);
}

__device__ __forceinline__ float lse6(const float* t) {
  float m = t[0];
  for (int k = 1; k < 6; ++k) m = fmaxf(m, t[k]);
  float s = 0.0f;
  for (int k = 0; k < 6; ++k) s += expf(t[k] - m);
  return m + logf(s);
}

// One cell of one sweep (pairhmm._diag_step). prev2/prev1 are the
// [kStates][W] slabs of diagonals d-2 and d-1; xi/yj the emission codes;
// start_* the implicit START-state values of the three source cells.
__device__ __forceinline__ void diag_cell(
    const float* prev2, const float* prev1, int W, int i, int j, int xi, int yj,
    const float* tr, const float* match, const float* ins, float* out) {
  const float neg = kLogZero;
  // sources: (i-1, j-1) = prev2[i-1]; (i-1, j) = prev1[i-1]; (i, j-1) = prev1[i]
  float p2s[6], p1s[kStates], p1[kStates];
  for (int s = 0; s < kStates; ++s) {
    p2s[s] = i >= 1 ? prev2[s * W + i - 1] : neg;
    p1s[s] = i >= 1 ? prev1[s * W + i - 1] : neg;
    p1[s] = prev1[s * W + i];
  }
  // START lives only at (0, 0)
  p2s[5] = (i == 1 && j == 1) ? 0.0f : neg;
  const float p1s_start = (i == 1 && j == 0) ? 0.0f : neg;
  const float p1_start = (i == 0 && j == 1) ? 0.0f : neg;

  float t[6];
  for (int s = 0; s < 6; ++s) t[s] = p2s[s] + tr[s * 5 + M];
  const float cM = lse6(t) + match[xi * 5 + yj];
  const float ex = ins[xi], ey = ins[yj];
  const float cIX = lse3(p1s[M] + tr[M * 5 + IX], p1s[IX] + tr[IX * 5 + IX],
                         p1s_start + tr[5 * 5 + IX]) + ex;
  const float cJX = lse3(p1s[M] + tr[M * 5 + JX], p1s[JX] + tr[JX * 5 + JX],
                         p1s_start + tr[5 * 5 + JX]) + ex;
  const float cIY = lse3(p1[M] + tr[M * 5 + IY], p1[IY] + tr[IY * 5 + IY],
                         p1_start + tr[5 * 5 + IY]) + ey;
  const float cJY = lse3(p1[M] + tr[M * 5 + JY], p1[JY] + tr[JY * 5 + JY],
                         p1_start + tr[5 * 5 + JY]) + ey;
  out[M] = (i >= 1 && j >= 1) ? cM : neg;
  out[IX] = i >= 1 ? cIX : neg;
  out[JX] = i >= 1 ? cJX : neg;
  out[IY] = j >= 1 ? cIY : neg;
  out[JY] = j >= 1 ? cJY : neg;
}

__global__ void pairhmm_kernel(const int* __restrict__ X, const int* __restrict__ Y,
                               const int* __restrict__ LX, const int* __restrict__ LY,
                               const float* __restrict__ params, int L,
                               float* __restrict__ post, float* __restrict__ ea) {
  extern __shared__ float smem[];
  const int W = blockDim.x;  // >= L + 1, a multiple of 32
  float* prm = smem;                         // kParams
  float* buf = prm + kParams;                // 3 diagonals x kStates x W
  float* corner = buf + 3 * kStates * W;     // kStates
  int* xs = reinterpret_cast<int*>(corner + kStates);  // L
  int* ys = xs + L;                                    // L

  const int p = blockIdx.x;
  const int i = threadIdx.x;
  const int lx = LX[p], ly = LY[p];
  float* P = post + static_cast<size_t>(p) * L * L;

  for (int k = i; k < kParams; k += W) prm[k] = params[k];
  for (int k = i; k < L; k += W) {
    xs[k] = X[static_cast<size_t>(p) * L + k];
    ys[k] = Y[static_cast<size_t>(p) * L + k];
  }
  for (int k = i; k < L * L; k += W) P[k] = 0.0f;
  for (int k = i; k < 3 * kStates * W; k += W) buf[k] = kLogZero;
  if (i < kStates) corner[i] = kLogZero;
  __syncthreads();

  const float* start = prm + kStart;
  const float* match = prm + kMatch;
  const float* ins = prm + kIns;
  const int dend = lx + ly;

  // ---- 1. forward sweep ---------------------------------------------------
  for (int d = 1; d <= dend; ++d) {
    const float* prev2 = buf + ((d + 1) % 3) * kStates * W;
    const float* prev1 = buf + ((d + 2) % 3) * kStates * W;
    float* cur = buf + (d % 3) * kStates * W;
    const int j = d - i;
    float out[kStates];
    const bool valid = i <= lx && j >= 0 && j <= ly;
    if (valid) {
      const int xi = xs[max(i - 1, 0)];
      const int yj = ys[max(j - 1, 0)];
      diag_cell(prev2, prev1, W, i, j, xi, yj, prm + kTrans, match, ins, out);
      if (i >= 1 && j >= 1) P[(i - 1) * L + (j - 1)] = out[M];
      if (d == dend && i == lx)
        for (int s = 0; s < kStates; ++s) corner[s] = out[s];
    } else {
      for (int s = 0; s < kStates; ++s) out[s] = kLogZero;
    }
    if (i < W)
      for (int s = 0; s < kStates; ++s) cur[s * W + i] = out[s];
    __syncthreads();
  }

  float t5[kStates];
  for (int s = 0; s < kStates; ++s) t5[s] = corner[s] + start[s];
  const float total = lse5(t5);

  // ---- 2. reversed W-DP + fused posterior ---------------------------------
  for (int k = i; k < 3 * kStates * W; k += W) buf[k] = kLogZero;
  __syncthreads();
  const int a = i;  // reversed row: natural row lx - a
  if (a == 0 && lx >= 1 && ly >= 1) {
    // corner (lx, ly): backward M value is start[M] (end factor)
    float* c = P + (lx - 1) * L + (ly - 1);
    const float v = expf(fminf(*c + start[M] - total, 0.0f));
    *c = v >= kMinSparseProb ? v : 0.0f;
  }
  for (int d = 1; d <= dend; ++d) {
    const float* prev2 = buf + ((d + 1) % 3) * kStates * W;
    const float* prev1 = buf + ((d + 2) % 3) * kStates * W;
    float* cur = buf + (d % 3) * kStates * W;
    const int b = d - a;
    float out[kStates];
    const bool valid = a <= lx && b >= 0 && b <= ly;
    if (valid) {
      const int xi = a >= 1 ? xs[lx - a] : 4;  // reversed x at a - 1
      const int yj = b >= 1 ? ys[ly - b] : 4;
      diag_cell(prev2, prev1, W, a, b, xi, yj, prm + kTransRev, match, ins, out);
      const int ni = lx - a, nj = ly - b;
      if (ni >= 1 && nj >= 1) {
        for (int s = 0; s < kStates; ++s) t5[s] = out[s] + prm[kTrans + M * 5 + s];
        const float bm = lse5(t5);
        float* c = P + (ni - 1) * L + (nj - 1);
        const float v = expf(fminf(*c + bm - total, 0.0f));
        *c = v >= kMinSparseProb ? v : 0.0f;
      }
    } else {
      for (int s = 0; s < kStates; ++s) out[s] = kLogZero;
    }
    if (a < W)
      for (int s = 0; s < kStates; ++s) cur[s * W + a] = out[s];
    __syncthreads();
  }

  // ---- 3. MEA score over bf16-rounded posteriors ---------------------------
  // S[i,j] = max(S[i-1,j-1] + p(i,j), S[i-1,j], S[i,j-1]); S[i,0] = S[0,j] = 0
  float* s2 = buf;
  float* s1 = buf + W;
  float* s0 = buf + 2 * W;
  s2[i] = kLogZero;
  s1[i] = kLogZero;
  if (i == 0) s1[0] = 0.0f;  // (0, 0)
  __syncthreads();
  for (int d = 1; d <= dend; ++d) {
    const int j = d - i;
    float v = kLogZero;
    if (i <= lx && j >= 0 && j <= ly) {
      if (i == 0 || j == 0) {
        v = 0.0f;
      } else {
        const float pq = __bfloat162float(__float2bfloat16_rn(P[(i - 1) * L + (j - 1)]));
        v = fmaxf(fmaxf(s2[i - 1] + pq, s1[i - 1]), s1[i]);
      }
    }
    s0[i] = v;
    __syncthreads();
    float* tmp = s2;
    s2 = s1;
    s1 = s0;
    s0 = tmp;
  }
  if (i == lx) ea[p] = (dend >= 1) ? s1[lx] : 0.0f;
}

ffi::Error PairHmmImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> x, ffi::Buffer<ffi::S32> y,
                       ffi::Buffer<ffi::S32> lx, ffi::Buffer<ffi::S32> ly,
                       ffi::Buffer<ffi::F32> params, ffi::ResultBuffer<ffi::F32> post,
                       ffi::ResultBuffer<ffi::F32> ea) {
  const auto dims = x.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("x must be [P, Lmax]");
  const int P = static_cast<int>(dims[0]);
  const int L = static_cast<int>(dims[1]);
  if (params.element_count() != kParams)
    return ffi::Error::InvalidArgument("params must hold 95 floats");
  const int threads = ((L + 1 + 31) / 32) * 32;
  if (threads > 1024) return ffi::Error::InvalidArgument("Lmax must be <= 1023");
  if (P == 0) return ffi::Error::Success();
  const size_t smem = sizeof(float) * (kParams + 3 * kStates * threads + kStates) +
                      sizeof(int) * 2 * L;
  pairhmm_kernel<<<P, threads, smem, stream>>>(
      x.typed_data(), y.typed_data(), lx.typed_data(), ly.typed_data(),
      params.typed_data(), L, post->typed_data(), ea->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PairHmmPostEa, PairHmmImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()   // x [P, Lmax]
                                  .Arg<ffi::Buffer<ffi::S32>>()   // y [P, Lmax]
                                  .Arg<ffi::Buffer<ffi::S32>>()   // lx [P]
                                  .Arg<ffi::Buffer<ffi::S32>>()   // ly [P]
                                  .Arg<ffi::Buffer<ffi::F32>>()   // params [95]
                                  .Ret<ffi::Buffer<ffi::F32>>()   // post [P, Lmax, Lmax]
                                  .Ret<ffi::Buffer<ffi::F32>>());  // ea [P]
