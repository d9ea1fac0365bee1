// Flash attention forward: o = softmax(q k^T / sqrt(D) [causal]) v per
// batch*head, the S x S scores never written to device memory.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn.py::
// flash_attention (_flash_fwd_kernel).  Bound on the H100: operations.
// The causal forward does 4 BH D S(S+1)/2 flops on 4 BH S D elements of
// I/O, about S/2 flops per byte in bf16 (1024 at S = 2048), far above the
// card's ridge point: 6.88e10 flop at the serve shape (64, 2048, 128) is
// 0.0695 ms at the bf16 tensor-core peak of 989 TFLOP/s.
//
// bf16 inputs (flash_tc_kernel): the products run on the tensor cores as
// wgmma.mma_async bf16 x bf16 -> fp32.  One CTA of two warpgroups per
// (bh, 128-row q tile); warpgroup w owns q rows 64w..64w+63, and warp i of
// it rows 16i..16i+15 of those.  The q tile and each 64-row k and v tile
// arrive by 16-byte cp.async into shared memory, k and v into a ring of two
// stages (tile j+1 in flight while tile j is multiplied); rows past S are
// zero-filled (src-size 0), so nothing pads.  A tile is D/64 sub-tiles of
// [rows][64] bf16 in the 128-byte swizzle (16-byte chunk c of row r at
// c ^ (r & 7)), which wgmma's shared-memory descriptors read as they
// stand: S = Q K^T takes q and k from shared memory (both K-major), O +=
// P V takes P from registers and v from shared memory (MN-major, the
// transpose bit).  A k/v tile feeds both warpgroups, halving the L2 reads
// of a 64-row q tile.  The softmax runs online in registers: the row max
// and sum reduced over the 4 lanes of a quad that share a row of the
// accumulator fragment, the scale folded into exp2 (p = exp2(s log2(e) /
// sqrt(D) - m log2(e) / sqrt(D))), the accumulator rescaled at every
// tile.  P is rounded to bf16 in registers and is the A operand of P V as
// it stands: the accumulator fragment of an m64n16 score slice is the
// register fragment of an m64k16 A operand.  Rounding P to bf16 is what
// FlashAttention does; it adds at most 2^-9 max|v| to an output (the bar
// of flash_attn.py::bf16_error).  Only kv tiles that cross a warpgroup's
// diagonal, or S, are masked; a causal warpgroup skips the tiles above its
// diagonal, the kv loop ends at the CTA's, and the heaviest q tiles are
// issued first.
//
// float32 inputs (flash_fwd_kernel<float, D>) keep the CUDA-core kernel:
// one CTA of 256 threads per (bh, 64-row q tile), q/k/v tiles in shared
// memory (rows padded to D + 1 words), thread (ty, tx) of a 16 x 16 grid
// owning rows ty + 16 i of the scores and accumulator, the products with
// explicit fmaf (the library builds with --fmad=false).  Tensor cores in
// fp32 would mean TF32, which the port does not use.
//
// Rows and keys past the true S are masked against S (the caller pads
// nothing); the sums round differently from the plain version's matmuls,
// so the two agree to rounding, not bit for bit.
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace rt {

// ---- float32 on the CUDA cores (flash_fwd_kernel) ------------------------
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


// ---- bf16 on the tensor cores -------------------------------------------
constexpr int kTcWarps = 8;          // two warpgroups
constexpr int kTcBq = 16 * kTcWarps;  // q rows per CTA, 64 per warpgroup
constexpr int kTcBkv = 64;            // kv rows per tile
constexpr int kTcStages = 2;          // k/v tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

// bf16 elements of the shared memory: the q tile (kTcBq rows) and
// kTcStages k and v tiles (kTcBkv rows), each D wide
template <int D>
constexpr int tc_smem_elems() {
  return (kTcBq + 2 * kTcStages * kTcBkv) * D;
}

// element offset of 16-byte chunk c of row r in a tile of ROWS rows: D/64
// sub-tiles of [ROWS][64], each 128-byte row's chunks XOR-swizzled by r & 7
// (the wgmma 128-byte swizzle, with 1024-byte aligned tiles)
template <int ROWS>
__device__ __forceinline__ int swz(int r, int c) {
  return ((c >> 3) * ROWS + r) * 64 + (((c & 7) ^ (r & 7)) << 3);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void *src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t *>(&h);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at p
__device__ __forceinline__ uint64_t sw128_desc(const __nv_bfloat16 *p,
                                               uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of d across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a b, m64n64k16, a and b from shared memory; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= a b, m64n64k16, a from registers; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d (+)= a b, m64n128k16, a from registers; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// rows row0.. row0 + rows - 1 of a (seq, D) matrix into a swizzled tile;
// rows at or past seq are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16 *tile,
                                          const __nv_bfloat16 *g, int row0,
                                          int seq) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += 32 * kTcWarps) {
    const int r = i / CPR, c = i % CPR;
    const int row = row0 + r;
    const bool in = row < seq;
    cp_async16(smem_u32(tile + swz<ROWS>(r, c)),
               g + static_cast<long long>(in ? row : 0) * D + c * 8,
               in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kTcWarps)
flash_tc_kernel(const __nv_bfloat16 *__restrict__ q,
                const __nv_bfloat16 *__restrict__ k,
                const __nv_bfloat16 *__restrict__ v,
                __nv_bfloat16 *__restrict__ o, int seq, float scale,
                int causal) {
  constexpr int KK = D / 16;      // k16 steps of Q K^T
  constexpr int NS = kTcBkv / 8;  // n8 blocks of a score row
  constexpr int NO = D / 8;       // n8 blocks of an output row
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  __nv_bfloat16 *sq = reinterpret_cast<__nv_bfloat16 *>(tc_smem);
  __nv_bfloat16 *sk = sq + kTcBq * D;                 // kTcStages tiles
  __nv_bfloat16 *sv = sk + kTcStages * kTcBkv * D;    // kTcStages tiles

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const long long base = static_cast<long long>(blockIdx.y) * seq * D;
  const int q0 = qt * kTcBq;
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;       // warpgroup: 64 q rows each
  const int warp = (threadIdx.x >> 5) & 3;  // warp in the warpgroup
  const int qw0 = q0 + 64 * wg;          // the warpgroup's first q row
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const float sl = scale * kLog2e;

  int n_kv = (seq + kTcBkv - 1) / kTcBkv;
  if (causal) n_kv = min(n_kv, (q0 + kTcBq - 1) / kTcBkv + 1);

  load_tile<D, kTcBq>(sq, q + base, q0, seq);
  load_tile<D, kTcBkv>(sk, k + base, 0, seq);
  load_tile<D, kTcBkv>(sv, v + base, 0, seq);
  cp_async_commit();

  float acc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, rows g, g + 8
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int j = 0; j < n_kv; ++j) {
    const int st = j % kTcStages;
    if (j + 1 < n_kv) {
      const int nx = (j + 1) % kTcStages;
      load_tile<D, kTcBkv>(sk + nx * kTcBkv * D, k + base, (j + 1) * kTcBkv,
                           seq);
      load_tile<D, kTcBkv>(sv + nx * kTcBkv * D, v + base, (j + 1) * kTcBkv,
                           seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // the tiles were written by cp.async (generic proxy); wgmma reads them
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const __nv_bfloat16 *tk = sk + st * kTcBkv * D;
    const __nv_bfloat16 *tv = sv + st * kTcBkv * D;

    const int k0 = j * kTcBkv;
    // a causal tile wholly above the warpgroup's diagonal adds nothing
    if (causal && k0 > qw0 + 63) {
      __syncthreads();
      continue;
    }
    // S = Q K^T: the warpgroup's 64 q rows against the tile's 64 keys
    float s[NS * 4];
    const __nv_bfloat16 *qw = sq + wg * 64 * 64;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      // sub-tile kk / 4 of 64 columns, then 32 bytes per k16 step
      const int c = (kk & 3) * 16;
      wgmma_ss_n64(s, sw128_desc(qw + (kk >> 2) * kTcBq * 64 + c, 16, 1024),
                   sw128_desc(tk + (kk >> 2) * kTcBkv * 64 + c, 16, 1024),
                   kk > 0);
    }
    wg_commit();
    wg_wait0();
    reg_fence(s);

    if ((causal && k0 + kTcBkv - 1 > qw0) || k0 + kTcBkv > seq) {
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) {
        const int row = qw0 + warp * 16 + g + (((i >> 1) & 1) << 3);
        const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        if (col >= seq || (causal && col > row)) s[i] = -CUDART_INF_F;
      }
    }

    // online softmax: rows g (h = 0) and g + 8 (h = 1) of the warp's 16
    float corr[2], ms[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int nb = 0; nb < NS; ++nb)
        mx = fmaxf(mx, fmaxf(s[4 * nb + 2 * h], s[4 * nb + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with no key yet keeps -inf: subtract 0 so no inf - inf
      ms[h] = mx == -CUDART_INF_F ? 0.f : mx * sl;
      corr[h] = exp2f(__fmaf_rn(m[h], sl, -ms[h]));
      m[h] = mx;
    }
    float rs[2] = {0.f, 0.f};
    uint32_t pf[NS / 2][4];  // P as m64k16 A fragments, kv steps of 16
#pragma unroll
    for (int nb = 0; nb < NS; ++nb) {
      const float p0 = exp2f(__fmaf_rn(s[4 * nb], sl, -ms[0]));
      const float p1 = exp2f(__fmaf_rn(s[4 * nb + 1], sl, -ms[0]));
      const float p2 = exp2f(__fmaf_rn(s[4 * nb + 2], sl, -ms[1]));
      const float p3 = exp2f(__fmaf_rn(s[4 * nb + 3], sl, -ms[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[nb >> 1][(nb & 1) << 1] = pack_bf16(p0, p1);
      pf[nb >> 1][((nb & 1) << 1) + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = __fmaf_rn(l[h], corr[h], rs[h]);
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) acc[i] *= corr[(i >> 1) & 1];

    // O += P V: P from registers, V (kv rows x D, D contiguous) is the
    // MN-major B operand
    reg_fence(acc);
    wg_fence();
#pragma unroll
    for (int kv = 0; kv < NS / 2; ++kv) {
      const uint64_t db = sw128_desc(tv + kv * 16 * 64, kTcBkv * 128, 1024);
      if constexpr (D == 64)
        wgmma_rs_n64(acc, pf[kv], db, 1);
      else
        wgmma_rs_n128(acc, pf[kv], db, 1);
    }
    wg_commit();
    wg_wait0();
    reg_fence(acc);
    __syncthreads();  // stage st is refilled by the next iteration's load
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / sum;
    const int row = qw0 + warp * 16 + g + 8 * h;
    if (row >= seq) continue;
    __nv_bfloat16 *orow = o + base + static_cast<long long>(row) * D;
#pragma unroll
    for (int nb = 0; nb < NO; ++nb)
      *reinterpret_cast<__nv_bfloat162 *>(orow + nb * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[4 * nb + 2 * h] * inv,
                                acc[4 * nb + 2 * h + 1] * inv);
  }
}

template <int D>
int launch_flash_tc(const void *q, const void *k, const void *v, void *o,
                    int bh, int seq, float scale, int causal,
                    cudaStream_t st) {
  const size_t smem = tc_smem_elems<D>() * sizeof(__nv_bfloat16);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((seq + kTcBq - 1) / kTcBq, bh);
  flash_tc_kernel<D><<<grid, 32 * kTcWarps, smem, st>>>(
      static_cast<const __nv_bfloat16 *>(q),
      static_cast<const __nv_bfloat16 *>(k),
      static_cast<const __nv_bfloat16 *>(v), static_cast<__nv_bfloat16 *>(o),
      seq, scale, causal);
  return 0;
}

// ---- float32 on the CUDA cores -------------------------------------------
template <int D>
int launch_flash_f32(const void *q, const void *k, const void *v, void *o,
                     int bh, int seq, float scale, int causal,
                     cudaStream_t st) {
  const size_t smem = flash_smem_floats<D>() * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((seq + kFlashBq - 1) / kFlashBq, bh);
  flash_fwd_kernel<float, D><<<grid, kFlashThreads, smem, st>>>(
      static_cast<const float *>(q), static_cast<const float *>(k),
      static_cast<const float *>(v), static_cast<float *>(o), seq, scale,
      causal);
  return 0;
}

}  // namespace rt

// q, k, v, o: (bh, seq, d) contiguous, dtype code sto (f32 or bf16);
// d 64 or 128.  Returns a cudaError_t (0 on success).
extern "C" int rt_flash_attention(int sto, const void *q, const void *k,
                                  const void *v, void *o, int bh, int seq,
                                  int d, float scale, int causal,
                                  void *stream) {
  using namespace rt;
  if (bh < 1 || bh > 65535 || seq < 1 || (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (sto) {
    case kF32:
      rc = d == 64
               ? launch_flash_f32<64>(q, k, v, o, bh, seq, scale, causal, st)
               : launch_flash_f32<128>(q, k, v, o, bh, seq, scale, causal, st);
      break;
    case kBF16:
      rc = d == 64
               ? launch_flash_tc<64>(q, k, v, o, bh, seq, scale, causal, st)
               : launch_flash_tc<128>(q, k, v, o, bh, seq, scale, causal, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
