// Shared pieces of the port's CUDA kernels (sm_90a, plain C interface).
//
// dtype codes, the storage <-> accumulator conversions, the band-offset
// parameter block, a deterministic block reduction and the second-stage
// row reduction that finishes every cross-block sum.  Cross-block sums
// never use float atomics: each CTA writes its partials to a
// (k, n_blocks, NC) scratch tensor and reduce_rows_kernel sums them in a
// fixed order, so a result is bit-identical from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace rt {

// dtype codes; kernels/build.py keeps the same table
enum DType : int { kF32 = 0, kF64 = 1, kBF16 = 2, kFP8E4M3 = 3 };

// rows per CTA of every row-parallel kernel (one thread per row)
constexpr int kBlock = 256;
// the most bands a DIA operator may carry: glen_law_band(bandwidth <= 15);
// the paper's second operator, glen_law_band(bandwidth=10), has 21.  Only
// the Offsets parameter block is sized by it (132 bytes); no per-thread
// array is
constexpr int kMaxBands = 32;

struct Offsets {
  int nb;
  int off[kMaxBands];
};

// fp8 e4m3 storage as raw bits; converted with the documented intrinsics
struct e4m3 {
  __nv_fp8_storage_t bits;
};

template <typename T> struct Tag { using type = T; };

// ---- loads: storage -> accumulator ------------------------------------
template <typename T> __device__ __forceinline__ T up(float v) {
  return static_cast<T>(v);
}
template <typename T> __device__ __forceinline__ T up(double v) {
  return static_cast<T>(v);
}
template <typename T> __device__ __forceinline__ T up(__nv_bfloat16 v) {
  return static_cast<T>(__bfloat162float(v));
}
template <typename T> __device__ __forceinline__ T up(e4m3 v) {
  const __half_raw hr = __nv_cvt_fp8_to_halfraw(v.bits, __NV_E4M3);
  return static_cast<T>(__half2float(__half(hr)));
}

// ---- stores: accumulator -> storage (narrowing goes through float, as
// torch's .to(bfloat16) / .to(float8_e4m3fn) do) --------------------------
template <typename S> struct Store;
template <> struct Store<float> {
  template <typename T> __device__ static float of(T v) {
    return static_cast<float>(v);
  }
};
template <> struct Store<double> {
  template <typename T> __device__ static double of(T v) {
    return static_cast<double>(v);
  }
};
template <> struct Store<__nv_bfloat16> {
  template <typename T> __device__ static __nv_bfloat16 of(T v) {
    return __float2bfloat16(static_cast<float>(v));
  }
};
template <> struct Store<e4m3> {
  template <typename T> __device__ static e4m3 of(T v) {
    e4m3 o;
    o.bits = __nv_cvt_float_to_fp8(static_cast<float>(v), __NV_NOSAT,
                                   __NV_E4M3);
    return o;
  }
};

// ---- host-side dtype dispatch ------------------------------------------
template <typename T, typename F> int with_storage(int sto, F &f) {
  switch (sto) {
    case kF32: return f(Tag<T>{}, Tag<float>{});
    case kF64: return f(Tag<T>{}, Tag<double>{});
    case kBF16: return f(Tag<T>{}, Tag<__nv_bfloat16>{});
    case kFP8E4M3: return f(Tag<T>{}, Tag<e4m3>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f(Tag<accumulator>, Tag<storage>) for accumulator in {f32, f64}
template <typename F> int with_types(int acc, int sto, F &&f) {
  switch (acc) {
    case kF32: return with_storage<float>(sto, f);
    case kF64: return with_storage<double>(sto, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f(Tag<T>) for T in {f32, f64}: kernels that store nothing narrower
template <typename F> int with_accum(int acc, F &&f) {
  switch (acc) {
    case kF32: return f(Tag<float>{});
    case kF64: return f(Tag<double>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// row m of right-hand side j of a carried (k, n) vector: the local rows,
// else the (k, h2) strips to the left and right (null: zero), else zero
template <typename T, typename S>
__device__ __forceinline__ T vec_at(const S *v, const S *lo, const S *hi,
                                    long long j, long long m, long long n,
                                    int h2) {
  if (m >= 0 && m < n) return up<T>(v[j * n + m]);
  if (m < 0) return (lo != nullptr && m >= -h2) ? up<T>(lo[j * h2 + m + h2])
                                                : T(0);
  return (hi != nullptr && m < n + h2) ? up<T>(hi[j * h2 + (m - n)]) : T(0);
}

inline long long blocks_for(long long n) { return (n + kBlock - 1) / kBlock; }

// ---- deterministic block reduction --------------------------------------
// Sums v[c] over the CTA (blockDim.x a multiple of 32, at most 1024);
// the totals are valid in thread 0.  Warp shuffles in a fixed tree, then
// warp 0 over the per-warp sums: the same order on every run.
template <typename T, int NV>
__device__ __forceinline__ void block_reduce(T (&v)[NV]) {
  __shared__ T smem[32][NV];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    T x = v[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    v[c] = x;
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) smem[warp][c] = v[c];
  }
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      T x = lane < nwarps ? smem[lane][c] : T(0);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, o);
      v[c] = x;
    }
  }
  __syncthreads();  // smem may be reused by the caller's next reduction
}

// red[j, c] = sum_b partials[j, b, c] in a fixed order; grid (k), block kBlock
template <typename T, int NC>
__global__ void reduce_rows_kernel(const T *__restrict__ partials,
                                   T *__restrict__ red, int nblk) {
  const long long j = blockIdx.x;
  T v[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) v[c] = T(0);
  for (int b = threadIdx.x; b < nblk; b += blockDim.x) {
    const T *row = partials + (j * nblk + b) * NC;
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] += row[c];
  }
  block_reduce<T, NC>(v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) red[j * NC + c] = v[c];
  }
}

}  // namespace rt
