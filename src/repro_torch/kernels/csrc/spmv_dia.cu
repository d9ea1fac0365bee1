// Banded (DIA) SpMV: y[j, i] = sum_b bands[b, i] * x[j, i + off_b].
//
// Replaces the Pallas TPU kernel repro/kernels/spmv_dia.py::spmv_dia.
// Bound on the H100: bytes.  Each row reads n_bands band values and one x
// value and writes one y value (5 words per row for the tridiagonal
// operator), against 2 n_bands flops, far below the card's ridge point.
// Design: one thread per row, neighbouring threads on neighbouring rows so
// every band row and x are read coalesced; the +-h neighbour reads of x
// hit L1/L2.  Rows outside [0, n) read as zero through a bounds check,
// so the caller passes x unpadded (the TPU kernel took a zero-extended
// copy).  The band terms are folded left to right in band order, the
// order of the plain version, and the build turns off FMA contraction, so
// kernel and plain version agree to the last bit on the same inputs.
#include "common.cuh"

namespace rt {

template <typename T, typename S>
__global__ void spmv_dia_kernel(Offsets offs, const S *__restrict__ bands,
                                const T *__restrict__ x, T *__restrict__ y,
                                long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const long long j = blockIdx.y;
  const T *xj = x + j * n;
  T acc = T(0);
  for (int b = 0; b < offs.nb; ++b) {
    const long long m = i + offs.off[b];
    const T xm = (m >= 0 && m < n) ? xj[m] : T(0);
    acc = acc + up<T>(bands[b * n + i]) * xm;
  }
  y[j * n + i] = acc;
}

}  // namespace rt

extern "C" int rt_spmv_dia(int acc, int sto, const int *offsets, int nb,
                           long long n, int k, const void *bands,
                           const void *x, void *y, void *stream) {
  using namespace rt;
  if (nb < 1 || nb > kMaxBands || n < 1 || k < 1 || k > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs{};
  offs.nb = nb;
  for (int b = 0; b < nb; ++b) offs.off[b] = offsets[b];
  const dim3 grid(static_cast<unsigned>(blocks_for(n)), k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = with_types(acc, sto, [&](auto ta, auto ts) -> int {
    using T = typename decltype(ta)::type;
    using S = typename decltype(ts)::type;
    spmv_dia_kernel<T, S><<<grid, kBlock, 0, st>>>(
        offs, static_cast<const S *>(bands), static_cast<const T *>(x),
        static_cast<T *>(y), n);
    return 0;
  });
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
