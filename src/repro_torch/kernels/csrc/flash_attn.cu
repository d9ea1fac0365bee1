// Flash attention forward: o = softmax(q k^T / sqrt(D) [causal]) v per
// batch*head, the S x S scores never written to device memory.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn.py::
// flash_attention (_flash_fwd_kernel).  Bound on the H100: operations.
// The causal forward does 4 BH D S(S+1)/2 flops on 4 BH S D elements of
// I/O, about S/2 flops per byte in bf16 (1024 at S = 2048), far above the
// card's ridge point.
//
// Design (simple first; wgmma, TMA and a grouped-kv layout are later
// work): one CTA of 256 threads per (bh, 64-row q tile).  The q tile and
// each 64-row k and v tile are widened to fp32 in shared memory (dynamic,
// past 48 KB with the opt-in attribute), the q and k rows padded to D + 1
// words so the dot products read them without bank conflicts.  Thread
// (ty, tx) of a 16 x 16 grid owns rows ty + 16 i (i < 4) of the tile: the
// 4 x 4 scores at columns tx + 16 j and the 4 x D/16 accumulator entries
// at columns tx + 16 c, both in registers.  The softmax runs online in
// fp32 (running max m and sum l per row, reduced over the 16 lanes of a
// half warp by xor shuffles; the accumulator rescaled by exp(m - m_new)),
// and the probabilities pass through shared memory into the P V product.
// The causal kv loop ends at the q tile's diagonal tile, and the tiles are
// issued heaviest first.  Rows and keys past the true S are masked here
// (the caller pads nothing); -1e30 is the mask value, as in the
// reference.  The products use explicit fmaf (the library builds with
// --fmad=false), so the sums round differently from the plain version's
// matmul: the two agree to float32 rounding, not bit for bit.
#include "common.cuh"

namespace rt {

constexpr int kFlashBq = 64;      // q rows per CTA
constexpr int kFlashBkv = 64;     // kv rows per tile
constexpr int kFlashThreads = 256;
constexpr float kFlashNegInf = -1e30f;

template <int D>
constexpr int flash_smem_floats() {
  return kFlashBq * (D + 1) + kFlashBkv * (D + 1) + kFlashBkv * D +
         kFlashBq * (kFlashBkv + 1);
}

template <typename S, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const S *__restrict__ q, const S *__restrict__ k,
                 const S *__restrict__ v, S *__restrict__ o, int seq,
                 float scale, int causal) {
  constexpr int LD = D + 1;           // padded row stride of q and k tiles
  constexpr int LP = kFlashBkv + 1;   // row stride of the probability tile
  constexpr int NC = D / 16;          // accumulator columns per thread
  extern __shared__ float smem[];
  float *sq = smem;
  float *sk = sq + kFlashBq * LD;
  float *sv = sk + kFlashBkv * LD;
  float *sp = sv + kFlashBkv * D;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const long long base = static_cast<long long>(blockIdx.y) * seq * D;
  const int q0 = qt * kFlashBq;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int idx = tid; idx < kFlashBq * D; idx += kFlashThreads) {
    const int r = idx / D, c = idx % D;
    const int row = q0 + r;
    sq[r * LD + c] =
        row < seq ? up<float>(q[base + static_cast<long long>(row) * D + c])
                  : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kFlashNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (seq + kFlashBkv - 1) / kFlashBkv;
  if (causal) n_kv = min(n_kv, (q0 + kFlashBq - 1) / kFlashBkv + 1);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kFlashBkv;
    __syncthreads();  // the previous tile's P V product is done with sv, sp
    for (int idx = tid; idx < kFlashBkv * D; idx += kFlashThreads) {
      const int r = idx / D, c = idx % D;
      const int row = k0 + r;
      const long long g = base + static_cast<long long>(row) * D + c;
      sk[r * LD + c] = row < seq ? up<float>(k[g]) : 0.f;
      sv[r * D + c] = row < seq ? up<float>(v[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = sk[(tx + 16 * jj) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(a[i], b[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kFlashNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k0 + tx + 16 * jj;
        const bool keep = col < seq && (!causal || col <= row);
        s[i][jj] = keep ? s[i][jj] * scale : kFlashNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        sum += p;
        sp[(ty + 16 * i) * LP + tx + 16 * jj] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kFlashBkv; ++kk) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sv[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[base + static_cast<long long>(row) * D + tx + 16 * c] =
          Store<S>::of(acc[i][c] * inv_l);
  }
}

template <typename S, int D>
int launch_flash(const void *q, const void *k, const void *v, void *o,
                 int bh, int seq, float scale, int causal, cudaStream_t st) {
  const size_t smem = flash_smem_floats<D>() * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<S, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((seq + kFlashBq - 1) / kFlashBq, bh);
  flash_fwd_kernel<S, D><<<grid, kFlashThreads, smem, st>>>(
      static_cast<const S *>(q), static_cast<const S *>(k),
      static_cast<const S *>(v), static_cast<S *>(o), seq, scale, causal);
  return 0;
}

template <typename S>
int flash_for_dim(int d, const void *q, const void *k, const void *v,
                  void *o, int bh, int seq, float scale, int causal,
                  cudaStream_t st) {
  switch (d) {
    case 64: return launch_flash<S, 64>(q, k, v, o, bh, seq, scale, causal, st);
    case 128: return launch_flash<S, 128>(q, k, v, o, bh, seq, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace rt

// q, k, v, o: (bh, seq, d) contiguous, dtype code sto (f32 or bf16);
// d 64 or 128.  Returns a cudaError_t (0 on success).
extern "C" int rt_flash_attention(int sto, const void *q, const void *k,
                                  const void *v, void *o, int bh, int seq,
                                  int d, float scale, int causal,
                                  void *stream) {
  using namespace rt;
  if (bh < 1 || bh > 65535 || seq < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (sto) {
    case kF32:
      rc = flash_for_dim<float>(d, q, k, v, o, bh, seq, scale, causal, st);
      break;
    case kBF16:
      rc = flash_for_dim<__nv_bfloat16>(d, q, k, v, o, bh, seq, scale,
                                        causal, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
