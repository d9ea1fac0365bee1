// The eight PIPECG vector updates plus the next iteration's three dots.
//
// Replaces the Pallas TPU kernel repro/kernels/pipecg_fused.py::pipecg_fused,
// the FusedEngine's fallback when M is an opaque callable or A is
// matrix-free (the preconditioner and SpMV then run outside the kernel).
//
//   z' = n + beta z    q' = m + beta q    s' = w + beta s    p' = u + beta p
//   x' = x + alpha p'  r' = r - alpha s'  u' = u - alpha q'  w' = w - alpha z'
//   red = (<r',u'>, <w',u'>, <r',r'>)
//
// Bound on the H100: bytes.  Ten vectors are read and eight written per
// row (18 words) for 16 flops of updates and 6 of dots.  Design: one
// thread per row, all loads and stores coalesced, k right-hand sides on
// grid.y with (k,) alpha/beta read on the device.  Per-CTA dot partials go
// to a (k, n_blocks, 3) scratch tensor and a second kernel sums them in a
// fixed order (no float atomics: bit-identical from run to run).
#include "common.cuh"

namespace rt {

template <typename T> struct FusedArgs {
  long long n;
  int nblk;
  // x, r, u, w, m, n, z, q, s, p
  const T *in[10];
  // x', r', u', w', z', q', s', p'
  T *out[8];
  const T *alpha, *beta;
  T *partials;
};

template <typename T>
__global__ void pipecg_fused_kernel(const FusedArgs<T> a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long j = blockIdx.y;
  T v[3] = {T(0), T(0), T(0)};
  if (i < a.n) {
    const long long idx = j * a.n + i;
    const T alpha = a.alpha[j];
    const T beta = a.beta[j];
    const T x = a.in[0][idx], r = a.in[1][idx], u = a.in[2][idx];
    const T w = a.in[3][idx], m = a.in[4][idx], nn = a.in[5][idx];
    const T z = a.in[6][idx], q = a.in[7][idx], s = a.in[8][idx];
    const T p = a.in[9][idx];
    const T z2 = nn + beta * z;
    const T q2 = m + beta * q;
    const T s2 = w + beta * s;
    const T p2 = u + beta * p;
    const T x2 = x + alpha * p2;
    const T r2 = r - alpha * s2;
    const T u2 = u - alpha * q2;
    const T w2 = w - alpha * z2;
    a.out[0][idx] = x2;
    a.out[1][idx] = r2;
    a.out[2][idx] = u2;
    a.out[3][idx] = w2;
    a.out[4][idx] = z2;
    a.out[5][idx] = q2;
    a.out[6][idx] = s2;
    a.out[7][idx] = p2;
    v[0] = r2 * u2;
    v[1] = w2 * u2;
    v[2] = r2 * r2;
  }
  block_reduce<T, 3>(v);
  if (threadIdx.x == 0) {
    T *out = a.partials + (j * a.nblk + blockIdx.x) * 3;
    out[0] = v[0];
    out[1] = v[1];
    out[2] = v[2];
  }
}

}  // namespace rt

extern "C" int rt_pipecg_fused(int acc, long long n, int k,
                               const void *const *vecs_in,
                               void *const *vecs_out, const void *alpha,
                               const void *beta, void *partials, int nblk,
                               void *red, void *stream) {
  using namespace rt;
  if (n < 1 || k < 1 || k > 65535 || nblk != blocks_for(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nblk), k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the update kernel has no narrow storage: accumulator == storage
  const int rc = with_types(acc, acc, [&](auto ta, auto) -> int {
    using T = typename decltype(ta)::type;
    FusedArgs<T> a{};
    a.n = n;
    a.nblk = nblk;
    for (int v = 0; v < 10; ++v) a.in[v] = static_cast<const T *>(vecs_in[v]);
    for (int v = 0; v < 8; ++v) a.out[v] = static_cast<T *>(vecs_out[v]);
    a.alpha = static_cast<const T *>(alpha);
    a.beta = static_cast<const T *>(beta);
    a.partials = static_cast<T *>(partials);
    pipecg_fused_kernel<T><<<grid, kBlock, 0, st>>>(a);
    reduce_rows_kernel<T, 3><<<k, kBlock, 0, st>>>(
        static_cast<const T *>(partials), static_cast<T *>(red), nblk);
    return 0;
  });
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
