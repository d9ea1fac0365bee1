// RWKV-6 WKV recurrence, exact and sequential in time, per batch*head:
//   o_t = r_t S + (sum_i r_t,i u_i k_t,i) v_t
//   S  <- diag(exp(logw_t)) S + k_t^T v_t          (S: D x D, fp32)
//
// Replaces the Pallas TPU kernel repro/kernels/wkv.py::wkv_recurrent
// (_wkv_kernel).  Bound on the H100: bytes.  Each step reads 4 D inputs
// and writes D outputs against 5 D^2 flops: 16 flops per byte at D = 64
// in fp32, below the card's fp32 ridge point (67 TFLOP/s over 3.35 TB/s,
// 20).
//
// Design: the columns of S evolve independently (column j needs v_t[j]
// alone), so thread j of a CTA keeps column j of S in registers and the
// grid is (BH, D / C) with C = min(D, 32) columns per CTA: 512 CTAs for
// rwkv6-7b's 64 heads of 64 at batch 4.  r_t, k_t and exp(logw_t) of a
// chunk of 32 steps (16 at D = 128), and the CTA's v_t columns, are
// staged in shared memory (widened to fp32) by all the CTA's threads; the
// bonus sum_i r u k of each step is reduced once, by one thread in index
// order, and read by every column.  Per step each thread then
// forms o_t[j] = sum_i r_i S_ij + bonus v_j (four interleaved partial
// sums, so the FMA chain is a quarter as long) and updates its column,
// S_ij = exp(logw_i) S_ij + k_i v_j: the reference's order, output
// before update.  The sums run in another order than the plain version's
// matmul: the two agree to float32 rounding, not bit for bit.
#include "common.cuh"

namespace rt {

template <typename S, int D, int C>
__global__ void __launch_bounds__(C)
wkv_kernel(const S *__restrict__ r, const S *__restrict__ k,
           const S *__restrict__ v, const S *__restrict__ logw,
           const S *__restrict__ u, float *__restrict__ o, int T) {
  constexpr int LD = D + 4;  // 16-byte rows, float4 reads
  // time steps staged per pass: 32, or 16 at D = 128 (the three D-wide
  // tiles stay inside the 48 KB of static shared memory)
  constexpr int kWkvChunk = D > 64 ? 16 : 32;
  __shared__ __align__(16) float sr[kWkvChunk][LD];
  __shared__ __align__(16) float sk[kWkvChunk][LD];
  __shared__ __align__(16) float sw[kWkvChunk][LD];
  __shared__ float sv[kWkvChunk][C];
  __shared__ float sb[kWkvChunk];
  __shared__ float su[D];

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.y * C;
  const long long base = static_cast<long long>(bh) * T * D;
  for (int i = tid; i < D; i += C) su[i] = up<float>(u[bh * D + i]);

  float st[D];
#pragma unroll
  for (int i = 0; i < D; ++i) st[i] = 0.f;

  for (int t0 = 0; t0 < T; t0 += kWkvChunk) {
    const int n = min(kWkvChunk, T - t0);
    __syncthreads();  // the previous chunk's steps are done with the tiles
    for (int idx = tid; idx < n * D; idx += C) {
      const int tt = idx / D, i = idx % D;
      const long long g = base + static_cast<long long>(t0 + tt) * D + i;
      sr[tt][i] = up<float>(r[g]);
      sk[tt][i] = up<float>(k[g]);
      sw[tt][i] = expf(up<float>(logw[g]));
    }
    for (int idx = tid; idx < n * C; idx += C) {
      const int tt = idx / C, c = idx % C;
      sv[tt][c] = up<float>(v[base + static_cast<long long>(t0 + tt) * D +
                              j0 + c]);
    }
    __syncthreads();
    for (int tt = tid; tt < n; tt += C) {
      float b = 0.f;
      for (int i = 0; i < D; ++i) b += sr[tt][i] * su[i] * sk[tt][i];
      sb[tt] = b;
    }
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][tid];
      const float4 *r4 = reinterpret_cast<const float4 *>(sr[tt]);
      const float4 *k4 = reinterpret_cast<const float4 *>(sk[tt]);
      const float4 *w4 = reinterpret_cast<const float4 *>(sw[tt]);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 rr = r4[q];
        a0 = fmaf(rr.x, st[4 * q + 0], a0);
        a1 = fmaf(rr.y, st[4 * q + 1], a1);
        a2 = fmaf(rr.z, st[4 * q + 2], a2);
        a3 = fmaf(rr.w, st[4 * q + 3], a3);
      }
      o[base + static_cast<long long>(t0 + tt) * D + j0 + tid] =
          ((a0 + a1) + (a2 + a3)) + sb[tt] * vj;
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 kk = k4[q];
        const float4 ww = w4[q];
        st[4 * q + 0] = fmaf(ww.x, st[4 * q + 0], kk.x * vj);
        st[4 * q + 1] = fmaf(ww.y, st[4 * q + 1], kk.y * vj);
        st[4 * q + 2] = fmaf(ww.z, st[4 * q + 2], kk.z * vj);
        st[4 * q + 3] = fmaf(ww.w, st[4 * q + 3], kk.w * vj);
      }
    }
  }
}

template <typename S, int D>
int launch_wkv(const void *r, const void *k, const void *v, const void *logw,
               const void *u, float *o, int bh, int T, cudaStream_t st) {
  constexpr int C = D < 32 ? D : 32;
  const dim3 grid(bh, D / C);
  wkv_kernel<S, D, C><<<grid, C, 0, st>>>(
      static_cast<const S *>(r), static_cast<const S *>(k),
      static_cast<const S *>(v), static_cast<const S *>(logw),
      static_cast<const S *>(u), o, T);
  return 0;
}

template <typename S>
int wkv_for_dim(int d, const void *r, const void *k, const void *v,
                const void *logw, const void *u, float *o, int bh, int T,
                cudaStream_t st) {
  switch (d) {
    case 16: return launch_wkv<S, 16>(r, k, v, logw, u, o, bh, T, st);
    case 32: return launch_wkv<S, 32>(r, k, v, logw, u, o, bh, T, st);
    case 64: return launch_wkv<S, 64>(r, k, v, logw, u, o, bh, T, st);
    case 128: return launch_wkv<S, 128>(r, k, v, logw, u, o, bh, T, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace rt

// r, k, v, logw: (bh, T, d) contiguous, u: (bh, d), all of dtype code sto
// (f32 or bf16); o: (bh, T, d) float32; d in {16, 32, 64, 128}.  Returns a
// cudaError_t (0 on success).
extern "C" int rt_wkv_recurrent(int sto, const void *r, const void *k,
                                const void *v, const void *logw,
                                const void *u, void *o, int bh, int T, int d,
                                void *stream) {
  using namespace rt;
  if (bh < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *out = static_cast<float *>(o);
  int rc;
  switch (sto) {
    case kF32:
      rc = wkv_for_dim<float>(d, r, k, v, logw, u, out, bh, T, st);
      break;
    case kBF16:
      rc = wkv_for_dim<__nv_bfloat16>(d, r, k, v, logw, u, out, bh, T, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
