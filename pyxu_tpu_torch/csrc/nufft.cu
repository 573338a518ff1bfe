// 2-D NUFFT spread and interp for Hopper (sm_90a): the exponential-of-
// semicircle (ES) kernel scatter of point strengths onto a periodic fine
// grid, and its adjoint, the gather from the grid at the points.
//
// Replaces the six 2-D Pallas TPU kernels of pyxu_tpu/ops/pallas_nufft.py,
// which compute these two functions through three tilings chosen by how
// the points lie: spread = slab_spread (:126), strip_spread2 (:711),
// ragged_spread2 (:842); interp = slab_interp (:193), strip_interp2 (:778),
// ragged_interp2 (:897).  Those tilings exist for the MXU and VMEM; one
// kernel of each kind here takes any point set.  Semantics:
// nufft_spread2_plain / nufft_interp2_plain in pyxu_tpu_torch/ops/nufft.py.
//
// Function, per batch element b, with the plan's w taps per axis:
//   spread: g[b, (i0_1 + t1) mod n1, (i0_2 + t2) mod n2] +=
//           c[b, p] * phi(z1(t1)) * phi(z2(t2))
//   interp: out[b, p] = sum_{t1,t2} g[b, ...] * phi(z1(t1)) * phi(z2(t2))
// with phi(z) = exp(beta (sqrt(1 - z^2) - 1)) on |z| <= 1, and
// z(t) = (t - off) * 2 / w, off = x / h - i0 in (w/2 - 1, w/2].  Values are
// complex, stored as (re, im) pairs; the grid is (n1, n2) row-major.
//
// Design: the cuFINUFFT subproblem method.  The plan (built on the device in
// float64, ops/nufft.py plan2) sorts the points by 32x32 bin of their left
// tap and splits bins of more than NU_MAXSUB points into subproblems, so a
// dense bin does not serialise one block.  One block per (subproblem, batch
// element):
//   spread: zero a shared subgrid, the bin plus a w-1 halo; each thread
//           takes points, evaluates 2w ES weights from the stored offsets
//           and adds the w^2 products with shared atomics; then one pass
//           adds the subgrid into the global grid with global atomics,
//           wrapping both axes.
//   interp: load the bin's padded subgrid (wrapping) into shared memory;
//           each thread sums one point's w^2 taps and writes the result to
//           the point's original index (the plan's permutation).
// Strengths are read, and results written, through the permutation, so
// both take and return points in their original order.
//
// Bound (the chip_smoke.py kernel phase, M points, w taps): bytes = the
// points' plan data and values read once plus the grid written (spread) or
// read (interp) once; operations = M (w^2 complex-by-real multiply-adds +
// 2w ES evaluations).  At 10^6 points, w = 7, a 2048^2 f32 grid the grid's
// 33.5 MB dominate the bytes (~13 us at 3.35 TB/s).  The design keeps the
// w^2 updates of a point in shared memory; global traffic is one atomic
// pass per subgrid cell.  No TMA, no clusters, no tuning yet.
//
// Float atomics sum in an order that changes from run to run.

#include <cuda_runtime.h>

#define NU_BIN 32        // bin side (grid cells); ops/nufft.py mirrors it
#define NU_MAXW 16       // most taps per axis
#define NU_THREADS 256

struct NuArgs {
  int n1, n2;     // fine grid
  int nb2;        // bins along axis 1
  int w, hw;      // taps per axis, w / 2
  int M;          // points
  double beta;
};

__device__ __forceinline__ float nu_exp(float v) { return expf(v); }
__device__ __forceinline__ double nu_exp(double v) { return exp(v); }
__device__ __forceinline__ float nu_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double nu_sqrt(double v) { return sqrt(v); }

// ES weight of tap t for offset off; scale = 2 / w in T
template <typename T>
__device__ __forceinline__ T nu_weight(T off, int t, T scale, T beta) {
  const T z = (T(t) - off) * scale;
  T q = T(1) - z * z;
  q = q > T(0) ? q : T(0);
  return fabs(z) <= T(1) ? nu_exp(beta * (nu_sqrt(q) - T(1))) : T(0);
}

__device__ __forceinline__ int nu_wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

template <typename T>
__global__ void __launch_bounds__(NU_THREADS)
nu_spread_kernel(const T* __restrict__ c, T* __restrict__ g,
                 const int* __restrict__ perm, const int* __restrict__ i0,
                 const T* __restrict__ off, const int* __restrict__ sub,
                 NuArgs a) {
  extern __shared__ __align__(16) unsigned char nu_smem[];
  T* S = reinterpret_cast<T*>(nu_smem);
  const int SS = NU_BIN + a.w - 1;
  const int bin = sub[3 * blockIdx.x], first = sub[3 * blockIdx.x + 1];
  const int last = first + sub[3 * blockIdx.x + 2];
  const int b1 = bin / a.nb2, b2 = bin - b1 * a.nb2;
  // global index of subgrid cell (0, 0)
  const int o1 = b1 * NU_BIN - a.hw, o2 = b2 * NU_BIN - a.hw;
  c += 2 * (long)blockIdx.y * a.M;
  g += 2 * (long)blockIdx.y * a.n1 * a.n2;
  for (int q = threadIdx.x; q < 2 * SS * SS; q += blockDim.x) S[q] = T(0);
  __syncthreads();

  const T beta = (T)a.beta, scale = (T)(2.0 / a.w);
  for (int j = first + threadIdx.x; j < last; j += blockDim.x) {
    const long p = perm[j];
    const T cr = c[2 * p], ci = c[2 * p + 1];
    const T off1 = off[j], off2 = off[a.M + j];
    T w2[NU_MAXW];
#pragma unroll
    for (int t = 0; t < NU_MAXW; ++t)
      if (t < a.w) w2[t] = nu_weight(off2, t, scale, beta);
    const int l1 = i0[j] - o1, l2 = i0[a.M + j] - o2;   // in [0, NU_BIN)
    for (int t1 = 0; t1 < a.w; ++t1) {
      const T v1 = nu_weight(off1, t1, scale, beta);
      T* row = S + 2 * ((l1 + t1) * SS + l2);
#pragma unroll
      for (int t2 = 0; t2 < NU_MAXW; ++t2) {
        if (t2 < a.w) {
          const T wt = v1 * w2[t2];
          atomicAdd(row + 2 * t2, cr * wt);
          atomicAdd(row + 2 * t2 + 1, ci * wt);
        }
      }
    }
  }
  __syncthreads();

  for (int q = threadIdx.x; q < SS * SS; q += blockDim.x) {
    const T re = S[2 * q], im = S[2 * q + 1];
    if (re == T(0) && im == T(0)) continue;
    const int u = q / SS, v = q - u * SS;
    T* dst = g + 2 * ((long)nu_wrap(o1 + u, a.n1) * a.n2 +
                      nu_wrap(o2 + v, a.n2));
    atomicAdd(dst, re);
    atomicAdd(dst + 1, im);
  }
}

template <typename T>
__global__ void __launch_bounds__(NU_THREADS)
nu_interp_kernel(const T* __restrict__ g, T* __restrict__ out,
                 const int* __restrict__ perm, const int* __restrict__ i0,
                 const T* __restrict__ off, const int* __restrict__ sub,
                 NuArgs a) {
  extern __shared__ __align__(16) unsigned char nu_smem[];
  T* S = reinterpret_cast<T*>(nu_smem);
  const int SS = NU_BIN + a.w - 1;
  const int bin = sub[3 * blockIdx.x], first = sub[3 * blockIdx.x + 1];
  const int last = first + sub[3 * blockIdx.x + 2];
  const int b1 = bin / a.nb2, b2 = bin - b1 * a.nb2;
  const int o1 = b1 * NU_BIN - a.hw, o2 = b2 * NU_BIN - a.hw;
  g += 2 * (long)blockIdx.y * a.n1 * a.n2;
  out += 2 * (long)blockIdx.y * a.M;
  for (int q = threadIdx.x; q < SS * SS; q += blockDim.x) {
    const int u = q / SS, v = q - u * SS;
    const T* src = g + 2 * ((long)nu_wrap(o1 + u, a.n1) * a.n2 +
                            nu_wrap(o2 + v, a.n2));
    S[2 * q] = src[0];
    S[2 * q + 1] = src[1];
  }
  __syncthreads();

  const T beta = (T)a.beta, scale = (T)(2.0 / a.w);
  for (int j = first + threadIdx.x; j < last; j += blockDim.x) {
    const T off1 = off[j], off2 = off[a.M + j];
    T w2[NU_MAXW];
#pragma unroll
    for (int t = 0; t < NU_MAXW; ++t)
      if (t < a.w) w2[t] = nu_weight(off2, t, scale, beta);
    const int l1 = i0[j] - o1, l2 = i0[a.M + j] - o2;
    T re = T(0), im = T(0);
    for (int t1 = 0; t1 < a.w; ++t1) {
      const T v1 = nu_weight(off1, t1, scale, beta);
      const T* row = S + 2 * ((l1 + t1) * SS + l2);
#pragma unroll
      for (int t2 = 0; t2 < NU_MAXW; ++t2) {
        if (t2 < a.w) {
          const T wt = v1 * w2[t2];
          re += row[2 * t2] * wt;
          im += row[2 * t2 + 1] * wt;
        }
      }
    }
    const long p = perm[j];
    out[2 * p] = re;
    out[2 * p + 1] = im;
  }
}

template <typename T>
static int nu_launch(bool spread, const void* src, void* dst,
                     const void* perm, const void* i0, const void* off,
                     const void* sub, int nsub, int B, const NuArgs& a,
                     cudaStream_t stream) {
  const int SS = NU_BIN + a.w - 1;
  const size_t smem = (size_t)2 * SS * SS * sizeof(T);   // <= 35,344 B
  const dim3 grid(nsub, B);
  if (spread)
    nu_spread_kernel<T><<<grid, NU_THREADS, smem, stream>>>(
        (const T*)src, (T*)dst, (const int*)perm, (const int*)i0,
        (const T*)off, (const int*)sub, a);
  else
    nu_interp_kernel<T><<<grid, NU_THREADS, smem, stream>>>(
        (const T*)src, (T*)dst, (const int*)perm, (const int*)i0,
        (const T*)off, (const int*)sub, a);
  return (int)cudaGetLastError();
}

static int nu_dispatch(bool spread, const void* src, void* dst,
                       const void* perm, const void* i0, const void* off,
                       const void* sub, int nsub, int B, int M, int n1,
                       int n2, int nb2, int w, double beta, int f64,
                       void* stream) {
  if (nsub < 1 || B < 1 || B > 65535 || M < 1 || n1 < 1 || n2 < 1 ||
      nb2 < 1 || w < 2 || w > NU_MAXW)
    return (int)cudaErrorInvalidValue;
  NuArgs a;
  a.n1 = n1; a.n2 = n2; a.nb2 = nb2; a.w = w; a.hw = w / 2; a.M = M;
  a.beta = beta;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return nu_launch<double>(spread, src, dst, perm, i0, off, sub, nsub, B,
                             a, s);
  return nu_launch<float>(spread, src, dst, perm, i0, off, sub, nsub, B, a,
                          s);
}

extern "C" {

// g (B, n1, n2, 2), zeroed by the caller, += the spread of the strengths
// c (B, M, 2).  perm (M,) int32, i0 (2, M) int32 and off (2, M) are the
// plan's sorted arrays; sub (nsub, 3) int32 holds (bin, first, count).
// f64: 1 for double values and offsets, 0 for float.  Returns
// cudaGetLastError() after the launch.
int nufft_spread2_launch(const void* c, void* g, const void* perm,
                         const void* i0, const void* off, const void* sub,
                         int nsub, int B, int M, int n1, int n2, int nb2,
                         int w, double beta, int f64, void* stream) {
  return nu_dispatch(true, c, g, perm, i0, off, sub, nsub, B, M, n1, n2,
                     nb2, w, beta, f64, stream);
}

// out (B, M, 2) = the interp of the grid g (B, n1, n2, 2) at the plan's
// points; arguments as for nufft_spread2_launch.
int nufft_interp2_launch(const void* g, void* out, const void* perm,
                         const void* i0, const void* off, const void* sub,
                         int nsub, int B, int M, int n1, int n2, int nb2,
                         int w, double beta, int f64, void* stream) {
  return nu_dispatch(false, g, out, perm, i0, off, sub, nsub, B, M, n1, n2,
                     nb2, w, beta, f64, stream);
}

const char* nufft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
