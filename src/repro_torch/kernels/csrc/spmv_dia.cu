// Banded (DIA) SpMV: y[j, i] = sum_b bands[b, i] * x[j, i + off_b].
//
// Replaces the Pallas TPU kernel repro/kernels/spmv_dia.py::spmv_dia, in
// both of its entries: the unpadded one (rt_spmv_dia) and the
// halo-extended one of repro/kernels/ops.py::spmv_dia_ext
// (rt_spmv_dia_ext), where x_ext = [left strip, x, right strip] holds
// ``halo`` neighbour rows on each side and y[i] reads x_ext[i + halo +
// off_b].
// Bound on the H100: bytes.  Each row reads n_bands band values and one x
// value and writes one y value (5 words per row for the tridiagonal
// operator), against 2 n_bands flops, far below the card's ridge point.
// Design: one thread per row, neighbouring threads on neighbouring rows so
// every band row and x are read coalesced; the +-h neighbour reads of x
// hit L1/L2.  The unpadded entry reads rows outside [0, n) as zero
// through a bounds check, so the caller passes x unpadded (the TPU kernel
// took a zero-extended copy).  The extended entry (Ext) reads x_ext at
// i + halo + off_b with no mask: the strips supply the neighbour rows,
// and the wrapper checks that halo covers every offset.  The band terms
// are folded left to right in band order, the order of the plain
// versions, and the build turns off FMA contraction, so kernel and plain
// version agree to the last bit on the same inputs.
#include "common.cuh"

namespace rt {

template <typename T, typename S, bool Ext>
__global__ void spmv_dia_kernel(Offsets offs, const S *__restrict__ bands,
                                const T *__restrict__ x, T *__restrict__ y,
                                long long n, int halo) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const long long j = blockIdx.y;
  const T *xj = x + j * (Ext ? n + 2LL * halo : n);
  T acc = T(0);
  for (int b = 0; b < offs.nb; ++b) {
    const long long m = i + offs.off[b];
    T xm;
    if constexpr (Ext) {
      xm = xj[m + halo];
    } else {
      xm = (m >= 0 && m < n) ? xj[m] : T(0);
    }
    acc = acc + up<T>(bands[b * n + i]) * xm;
  }
  y[j * n + i] = acc;
}

template <bool Ext>
int launch_spmv_dia(int acc, int sto, const int *offsets, int nb,
                    long long n, int k, int halo, const void *bands,
                    const void *x, void *y, void *stream) {
  if (nb < 1 || nb > kMaxBands || n < 1 || k < 1 || k > 65535 || halo < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs{};
  offs.nb = nb;
  for (int b = 0; b < nb; ++b) {
    offs.off[b] = offsets[b];
    if (Ext && (offsets[b] > halo || -offsets[b] > halo))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks_for(n)), k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = with_types(acc, sto, [&](auto ta, auto ts) -> int {
    using T = typename decltype(ta)::type;
    using S = typename decltype(ts)::type;
    spmv_dia_kernel<T, S, Ext><<<grid, kBlock, 0, st>>>(
        offs, static_cast<const S *>(bands), static_cast<const T *>(x),
        static_cast<T *>(y), n, halo);
    return 0;
  });
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt

extern "C" int rt_spmv_dia(int acc, int sto, const int *offsets, int nb,
                           long long n, int k, const void *bands,
                           const void *x, void *y, void *stream) {
  return rt::launch_spmv_dia<false>(acc, sto, offsets, nb, n, k, 0, bands, x,
                                    y, stream);
}

extern "C" int rt_spmv_dia_ext(int acc, int sto, const int *offsets, int nb,
                               long long n, int k, int halo,
                               const void *bands, const void *x_ext, void *y,
                               void *stream) {
  return rt::launch_spmv_dia<true>(acc, sto, offsets, nb, n, k, halo, bands,
                                   x_ext, y, stream);
}
