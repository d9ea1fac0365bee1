// RWKV-6 WKV recurrence, exact and sequential in time, per batch*head:
//   o_t = r_t S + (sum_i r_t,i u_i k_t,i) v_t
//   S  <- diag(exp(logw_t)) S + k_t^T v_t          (S: D x D, fp32)
//
// Replaces the Pallas TPU kernel repro/kernels/wkv.py::wkv_recurrent
// (_wkv_kernel).
//
// What bounds it on the H100.  Each step reads 4 D inputs and writes D
// outputs: at rwkv6-7b's (256, 2048, 64) in float32 that is 671 MB, 0.2003
// ms at 3.35 TB/s.  Each step also costs 3 D^2 fp32 lane operations (D^2
// FMAs for o, D^2 FMULs and D^2 FMAs for the update), 6.4e9 at that shape:
// ~0.19 ms on 132 SMs x 128 lanes at ~1.98 GHz.  So the kernel has to
// stream at the byte rate AND keep the FP32 pipes busy: every load,
// shuffle, select and address beside the FMAs costs an issue slot, and a
// warp issues in order.  Tensor cores do not serve: TF32 keeps ~3 decimal
// digits (the bar is 2e-5 of max |o|), and the chunked factorised form
// (r e^{cum}, k e^{-cum}) overflows fp32 at logw = -8 (e^{128} in a
// 16-step chunk).  The recurrence stays exact and sequential on the CUDA
// cores, as the reference's.
//
// Design.
// * One CTA a head (two at D = 128, each over half the columns, so a
//   small batch still fills the card).  A thread keeps a block of S in
//   registers, kRows rows (a slice) by kCpt columns (8 x 4 at D = 64: 128
//   threads, two CTAs and 8 warps an SM at 256 heads), so each word it
//   reads from shared memory serves several FMAs: r_i, k_i, exp(logw_i)
//   a row serve kCpt columns, v_j a column kRows rows.  Slice s holds
//   the float4 row groups s, s + kSlices, ...: the slices of a warp read
//   neighbouring 16-byte words (no bank conflict).
// * o_t[j] is the sum of column j's kSlices slice partials, which sit in
//   lanes of one warp: a reduce-scatter butterfly over the columns
//   (__shfl_xor, a fixed tree) leaves column j's finished sum in one
//   lane, which stores it.  Same order in every run, no shared-memory
//   round trip, no atomics.
// * The steps are software-pipelined: step t + 1's inputs are read into
//   registers, and step t - 1's sums go through the butterfly and out,
//   while step t's FMAs run, so a warp's loads and shuffles overlap its
//   FMAs.  Only the update of S chains one step to the next.
// * The step inputs of a chunk of kChunk steps (x[bh, t0:t0+kChunk, :] is
//   contiguous) arrive by four 1-D bulk copies (TMA, one thread, on an
//   mbarrier) into a ring of two stages at the input's own dtype: chunk
//   c + 1 is in flight while chunk c's steps run.  No step runs past T.
// * Once a chunk lands, exp(logw) (and, for bf16 inputs, r, k and v
//   widened to fp32) are formed once a head into fp32 arrays by all
//   threads, and the bonus sum_i r u k of every step by NT / kChunk
//   threads a step (four values at a time, a fixed shuffle tree).
//   (Spreading them between the steps, or onto a warp of their own, ran
//   slower on an H100.)
// The reference's order is kept: output, then update.  The sums run in
// another order than the plain version's matmul: the two agree to float32
// rounding (2e-5 of max |o|), not bit for bit; a second launch repeats the
// first bit for bit.
#include <type_traits>

#include "common.cuh"

namespace rt {

// steps a stage (halved at D = 128, so a stage stays 32 KB in float32)
constexpr int kWkvChunk = 32;
// stages of the ring
constexpr int kWkvStages = 2;
// A launch shape at head dim D: R state rows by C columns a thread, SPLIT
// CTAs a head, each over D / SPLIT columns.
template <int D, int R, int C, int SPLIT> struct WkvShape {
  static constexpr int kDim = D;
  static constexpr int kSplit = SPLIT;           // CTAs a head
  static constexpr int kCols = D / SPLIT;        // state columns a CTA
  static constexpr int kRows = R;
  static constexpr int kCpt = C;
  static constexpr int kSlices = D / R;          // row slices a column
  static constexpr int kThreads = kSlices * kCols / C;
  static constexpr int kChunk = D > 64 ? kWkvChunk / 2 : kWkvChunk;
  static_assert(R % 4 == 0 && kSlices <= 32 && kThreads % 32 == 0 &&
                    kThreads <= 1024 && kThreads % kChunk == 0,
                "wkv shape");
};

// the shape each head dim launches (kernels/wkv.py::SHAPES)
template <int D> struct WkvPlan;
template <> struct WkvPlan<16> { using type = WkvShape<16, 4, 1, 1>; };
template <> struct WkvPlan<32> { using type = WkvShape<32, 4, 4, 1>; };
template <> struct WkvPlan<64> { using type = WkvShape<64, 8, 4, 1>; };
template <> struct WkvPlan<128> { using type = WkvShape<128, 8, 8, 2>; };

// dynamic shared memory: the stages [kWkvStages][4][kChunk][D] of S, then
// fp32 exp(logw) [kChunk][D], for bf16 inputs fp32 r, k, v [3][kChunk][D],
// then the bonus [kChunk] and u [D]
template <typename S, typename P> constexpr int wkv_smem() {
  constexpr int tile = P::kChunk * P::kDim;
  constexpr int wide = std::is_same<S, float>::value ? 1 : 4;
  return kWkvStages * 4 * tile * static_cast<int>(sizeof(S)) +
         wide * tile * 4 + (P::kChunk + P::kDim) * 4;
}

// four elements from shared memory, widened to fp32
__device__ __forceinline__ float4 load4(const float *p) {
  return *reinterpret_cast<const float4 *>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16 *p) {
  const uint2 w = *reinterpret_cast<const uint2 *>(p);  // bf16: high halves
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// Reduce-scatter of a[c], one step's partials of NV columns, over the
// lanes of a column's slices (lane bits below M * 2): at mask M, while
// more than one column is left, the lanes whose slice s has bit M keep
// the upper half of their columns and the others the lower half, each
// adding its partner's; once one is left the lanes add it across the
// remaining masks.  a[0, max(NV / slices, 1)) then hold the sums over all
// slices of the lane's columns (wkv_kernel's ``mine``).  A fixed tree: the
// same order on every run.
template <int M, int NV, int C>
__device__ __forceinline__ void reduce_cols(float (&a)[C], int s) {
  if constexpr (M >= 1) {
    if constexpr (NV > 1) {
      constexpr int H = NV / 2;
      const bool hi = (s & M) != 0;
#pragma unroll
      for (int g = 0; g < H; ++g) {
        const float send = hi ? a[g] : a[g + H];
        const float keep = hi ? a[g + H] : a[g];
        a[g] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      reduce_cols<M / 2, H>(a, s);
    } else {
      a[0] = a[0] + __shfl_xor_sync(0xffffffffu, a[0], M);
      reduce_cols<M / 2, 1>(a, s);
    }
  }
}

// ---- the stage ring: 1-D bulk copies (TMA) completing on an mbarrier ----
__device__ __forceinline__ void mbar_init(uint64_t *bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t *bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t *bar, int phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void *dst, const void *src,
                                          int bytes, uint64_t *bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <typename S, typename P>
__global__ void __launch_bounds__(P::kThreads, 2)
wkv_kernel(const S *__restrict__ r, const S *__restrict__ k,
           const S *__restrict__ v, const S *__restrict__ logw,
           const S *__restrict__ u, float *__restrict__ o, int T) {
  constexpr int D = P::kDim, C = P::kChunk, NT = P::kThreads;
  constexpr int NSL = P::kSlices, RPT = P::kRows, CPT = P::kCpt;
  constexpr bool kF32 = std::is_same<S, float>::value;
  constexpr int kTile = C * D;              // elements of one tensor a stage
  // columns a lane stores, and lanes that hold the same ones
  constexpr int kOut = CPT > NSL ? CPT / NSL : 1;
  constexpr int kShare = NSL > CPT ? NSL / CPT : 1;
  // threads a step of the bonus, and the values of i each sums
  constexpr int kTps = NT / C, kPart = D / kTps;
  static_assert(kTps <= 32 && kPart % 4 == 0, "wkv bonus split");

  extern __shared__ __align__(16) unsigned char dyn[];
  S *stage = reinterpret_cast<S *>(dyn);
  float *wf = reinterpret_cast<float *>(dyn + kWkvStages * 4 * kTile *
                                                  sizeof(S));
  float *xf = wf + kTile;                   // bf16: r, k, v widened
  float *bonus = xf + (kF32 ? 0 : 3 * kTile);
  float *su = bonus + C;                    // u, fp32
  __shared__ __align__(8) uint64_t bars[kWkvStages];

  const int bh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = lane % NSL;                 // row slice
  const int col = blockIdx.y * P::kCols +
                  (warp * (32 / NSL) + lane / NSL) * CPT;  // first column
  const int mine = col + (s / kShare) * kOut;  // first column stored
  const bool stores = s % kShare == 0;
  const long long base = static_cast<long long>(bh) * T * D;

  for (int i = tid; i < D; i += NT)
    su[i] = up<float>(u[static_cast<long long>(bh) * D + i]);
  if (tid == 0) {
    for (int q = 0; q < kWkvStages; ++q) mbar_init(&bars[q]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float st[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) st[i][c] = 0.f;

  const int nch = (T + C - 1) / C;
  // chunk c (its n rows of each tensor) into stage c % 2, by thread 0
  auto issue = [&](int c) {
    const int t0 = c * C, n = min(C, T - t0);
    const int bytes = n * D * static_cast<int>(sizeof(S));
    S *dst = stage + (c & 1) * 4 * kTile;
    const long long from = base + static_cast<long long>(t0) * D;
    mbar_expect(&bars[c & 1], 4 * bytes);
    bulk_copy(dst, r + from, bytes, &bars[c & 1]);
    bulk_copy(dst + kTile, k + from, bytes, &bars[c & 1]);
    bulk_copy(dst + 2 * kTile, v + from, bytes, &bars[c & 1]);
    bulk_copy(dst + 3 * kTile, logw + from, bytes, &bars[c & 1]);
  };

  __syncthreads();  // the barriers and u
  if (tid == 0) issue(0);
  for (int c = 0; c < nch; ++c) {
    mbar_wait(&bars[c & 1], (c >> 1) & 1);
    // chunk c has landed, and every thread is done with chunk c - 1's
    // stage, exp(logw) and bonus
    __syncthreads();
    if (tid == 0 && c + 1 < nch) issue(c + 1);
    const S *sg = stage + (c & 1) * 4 * kTile;
    const int t0 = c * C, n = min(C, T - t0);

#pragma unroll 2
    for (int e = 4 * tid; e < n * D; e += 4 * NT) {
      const float4 lw = load4(sg + 3 * kTile + e);
      *reinterpret_cast<float4 *>(wf + e) =
          make_float4(expf(lw.x), expf(lw.y), expf(lw.z), expf(lw.w));
      if constexpr (!kF32) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
          *reinterpret_cast<float4 *>(xf + q * kTile + e) =
              load4(sg + q * kTile + e);
      }
    }
    // the bonus: kTps threads a step, each over kPart consecutive i in
    // four partial sums, then a fixed shuffle tree over the kTps
    {
      const int tt = tid / kTps, i0 = (tid % kTps) * kPart;
      const S *rr = sg + tt * D + i0, *kk = sg + kTile + tt * D + i0;
      float b[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kPart; j += 4) {
        const float4 a = load4(rr + j), c = load4(kk + j),
                     w = *reinterpret_cast<const float4 *>(su + i0 + j);
        b[0] += a.x * w.x * c.x;
        b[1] += a.y * w.y * c.y;
        b[2] += a.z * w.z * c.z;
        b[3] += a.w * w.w * c.w;
      }
      float bt = (b[0] + b[1]) + (b[2] + b[3]);
#pragma unroll
      for (int m = 1; m < kTps; m <<= 1)
        bt += __shfl_xor_sync(0xffffffffu, bt, m);
      if (tid % kTps == 0 && tt < n) bonus[tt] = bt;
    }
    __syncthreads();

    const float *R;
    if constexpr (kF32)
      R = reinterpret_cast<const float *>(sg);
    else
      R = xf;
    const float *K = R + kTile, *V = R + 2 * kTile;

    // step tt's inputs into registers: r, k, exp(logw) of the thread's
    // rows, v of its columns, and the bonus and v of the columns it stores
    struct In {
      float r[RPT], k[RPT], w[RPT], v[CPT], b, vo[kOut];
    };
    auto read = [&](int tt, In &x) {
      const float4 *r4 = reinterpret_cast<const float4 *>(R + tt * D);
      const float4 *k4 = reinterpret_cast<const float4 *>(K + tt * D);
      const float4 *w4 = reinterpret_cast<const float4 *>(wf + tt * D);
#pragma unroll
      for (int q = 0; q < RPT / 4; ++q) {
        const float4 a = r4[s + NSL * q], b = k4[s + NSL * q],
                     c = w4[s + NSL * q];
        x.r[4 * q] = a.x, x.r[4 * q + 1] = a.y, x.r[4 * q + 2] = a.z,
        x.r[4 * q + 3] = a.w;
        x.k[4 * q] = b.x, x.k[4 * q + 1] = b.y, x.k[4 * q + 2] = b.z,
        x.k[4 * q + 3] = b.w;
        x.w[4 * q] = c.x, x.w[4 * q + 1] = c.y, x.w[4 * q + 2] = c.z,
        x.w[4 * q + 3] = c.w;
      }
      if constexpr (CPT >= 4) {
#pragma unroll
        for (int q = 0; q < CPT / 4; ++q) {
          const float4 a =
              reinterpret_cast<const float4 *>(V + tt * D + col)[q];
          x.v[4 * q] = a.x, x.v[4 * q + 1] = a.y, x.v[4 * q + 2] = a.z,
          x.v[4 * q + 3] = a.w;
        }
      } else if constexpr (CPT == 2) {
        const float2 a = *reinterpret_cast<const float2 *>(V + tt * D + col);
        x.v[0] = a.x, x.v[1] = a.y;
      } else {
        x.v[0] = V[tt * D + col];
      }
      x.b = bonus[tt];
#pragma unroll
      for (int q = 0; q < kOut; ++q) x.vo[q] = V[tt * D + mine + q];
    };

    // A warp issues in order, so the steps are software-pipelined: step
    // tt + 1's inputs are read, and step tt - 1's sums go through the
    // butterfly and out, while step tt's FMAs run.  Only the update of S
    // chains one step to the next.
    In cur, nxt;
    read(0, cur);
    float prev[CPT], pb = 0.f, pv[kOut];
#pragma unroll
    for (int c2 = 0; c2 < CPT; ++c2) prev[c2] = 0.f;
#pragma unroll
    for (int q = 0; q < kOut; ++q) pv[q] = 0.f;
    float *out = o + base + static_cast<long long>(t0) * D + mine;
#pragma unroll 2
    for (int tt = 0; tt < n; ++tt) {
      read(tt + 1, nxt);  // at tt = n - 1 a row never used, in the tile
      float acc[CPT];
#pragma unroll
      for (int c2 = 0; c2 < CPT; ++c2) acc[c2] = 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c2 = 0; c2 < CPT; ++c2)
          acc[c2] = fmaf(cur.r[i], st[i][c2], acc[c2]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c2 = 0; c2 < CPT; ++c2)
          st[i][c2] = fmaf(cur.w[i], st[i][c2], cur.k[i] * cur.v[c2]);
      reduce_cols<NSL / 2, CPT>(prev, s);
      if (tt > 0 && stores) {
#pragma unroll
        for (int q = 0; q < kOut; ++q)
          out[(tt - 1) * D + q] = prev[q] + pb * pv[q];
      }
#pragma unroll
      for (int c2 = 0; c2 < CPT; ++c2) prev[c2] = acc[c2];
      pb = cur.b;
#pragma unroll
      for (int q = 0; q < kOut; ++q) pv[q] = cur.vo[q];
      cur = nxt;
    }
    reduce_cols<NSL / 2, CPT>(prev, s);
    if (stores) {
#pragma unroll
      for (int q = 0; q < kOut; ++q)
        out[(n - 1) * D + q] = prev[q] + pb * pv[q];
    }
  }
}

template <typename S, typename P>
static int launch_wkv(const void *r, const void *k, const void *v,
                      const void *logw, const void *u, float *o, int bh,
                      int T, cudaStream_t st) {
  constexpr int smem = wkv_smem<S, P>();
  static int granted[kMaxDevices] = {};
  const int e = set_smem(reinterpret_cast<const void *>(wkv_kernel<S, P>),
                         smem, granted);
  if (e) return e;
  const dim3 grid(bh, P::kSplit);
  wkv_kernel<S, P><<<grid, P::kThreads, smem, st>>>(
      static_cast<const S *>(r), static_cast<const S *>(k),
      static_cast<const S *>(v), static_cast<const S *>(logw),
      static_cast<const S *>(u), o, T);
  return 0;
}

template <typename S>
static int wkv_for_dim(int d, const void *r, const void *k, const void *v,
                       const void *logw, const void *u, float *o, int bh,
                       int T, cudaStream_t st) {
  switch (d) {
    case 16:
      return launch_wkv<S, typename WkvPlan<16>::type>(r, k, v, logw, u, o,
                                                           bh, T, st);
    case 32:
      return launch_wkv<S, typename WkvPlan<32>::type>(r, k, v, logw, u, o,
                                                           bh, T, st);
    case 64:
      return launch_wkv<S, typename WkvPlan<64>::type>(r, k, v, logw, u, o,
                                                           bh, T, st);
    case 128:
      return launch_wkv<S, typename WkvPlan<128>::type>(r, k, v, logw, u, o,
                                                           bh, T, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace rt

// r, k, v, logw: (bh, T, d) contiguous, u: (bh, d), all of dtype code sto
// (f32 or bf16), r, k, v and logw starting on 16 bytes; o: (bh, T, d)
// float32; d in {16, 32, 64, 128}.  Returns a cudaError_t (0 on success).
extern "C" int rt_wkv_recurrent(int sto, const void *r, const void *k,
                                const void *v, const void *logw,
                                const void *u, void *o, int bh, int T, int d,
                                void *stream) {
  using namespace rt;
  if (bh < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto off16 = [](const void *p) {
    return reinterpret_cast<unsigned long long>(p) % 16 != 0;
  };
  if (off16(r) || off16(k) || off16(v) || off16(logw))
    return static_cast<int>(cudaErrorMisalignedAddress);
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
