// Fused multi-vector inner products: dots[j] = <V[j], z> for V (m, n).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_dots.py::fused_dots:
// all m coefficients (the sharded PIPECG body's init partials, the
// (P)GMRES orthogonalisation row) in one pass over V.
//
// Bound on the H100: bytes.  The pass must read V and z once, (m + 1) n
// words, for 2 m n flops.
//
// Design.
// * Each CTA owns a tile of kTile columns; each thread loads its kItems
//   values of z once into registers and reuses them for every row of V,
//   so z is read once however large m is.  Neighbouring threads read
//   neighbouring columns.
// * Rows of V go kRows at a time through one deterministic block
//   reduction; thread 0 writes the CTA's (m, n_blocks) partials.
// * Cross-block sums: reduce_rows_kernel finishes the partials in a fixed
//   order (the TPU kernel += into one block across an ordered grid, which
//   concurrent CTAs cannot do); no float atomics, so results repeat bit
//   for bit.
#include "common.cuh"

namespace rt {

constexpr int kItems = 4;                 // columns per thread
constexpr int kTile = kBlock * kItems;    // columns per CTA
constexpr int kRows = 8;                  // rows of V per block reduction

template <typename T>
__global__ void fused_dots_kernel(const T *__restrict__ V,
                                  const T *__restrict__ z, long long n, int m,
                                  int nblk, T *__restrict__ partials) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  T zt[kItems];
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const long long c = base + static_cast<long long>(t) * kBlock;
    zt[t] = c < n ? z[c] : T(0);
  }
  for (int j0 = 0; j0 < m; j0 += kRows) {
    T v[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      T s = T(0);
      if (j0 + q < m) {
        const T *row = V + static_cast<long long>(j0 + q) * n;
#pragma unroll
        for (int t = 0; t < kItems; ++t) {
          const long long c = base + static_cast<long long>(t) * kBlock;
          if (c < n) s = s + row[c] * zt[t];
        }
      }
      v[q] = s;
    }
    block_reduce<T, kRows>(v);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        if (j0 + q < m)
          partials[static_cast<long long>(j0 + q) * nblk + blockIdx.x] = v[q];
    }
  }
}

}  // namespace rt

extern "C" int rt_fused_dots(int dt, const void *V, const void *z,
                             long long n, int m, void *partials, int nblk,
                             void *out, void *stream) {
  using namespace rt;
  if (n < 1 || m < 1 || nblk != (n + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto tag) -> int {
    using T = typename decltype(tag)::type;
    fused_dots_kernel<T><<<nblk, kBlock, 0, st>>>(
        static_cast<const T *>(V), static_cast<const T *>(z), n, m, nblk,
        static_cast<T *>(partials));
    // partials (m, nblk) read as (k = m, nblk, NC = 1)
    reduce_rows_kernel<T, 1><<<m, kBlock, 0, st>>>(
        static_cast<const T *>(partials), static_cast<T *>(out), nblk);
    return 0;
  };
  int rc;
  switch (dt) {
    case kF32: rc = launch(Tag<float>{}); break;
    case kF64: rc = launch(Tag<double>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
