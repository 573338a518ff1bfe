// NUFFT spread and interp for Hopper (sm_90a), in 2-D and 3-D: the
// exponential-of-semicircle (ES) kernel scatter of point strengths onto a
// periodic fine grid, and its adjoint, the gather from the grid at the
// points.
//
// Replaces the sixteen NUFFT Pallas TPU kernels of pyxu_tpu/ops/
// pallas_nufft.py, which compute these four functions through tilings
// chosen by how the points lie.  2-D spread = slab_spread (:126),
// strip_spread2 (:711), ragged_spread2 (:842); 2-D interp = slab_interp
// (:193), strip_interp2 (:778), ragged_interp2 (:897).  3-D spread =
// slab_spread3 (:272), pencil_spread3 (:407), strip_spread3 (:563),
// ragged_spread3 (:961), ragged_pencil_spread3 (:1097); 3-D interp =
// slab_interp3 (:325), pencil_interp3 (:474), strip_interp3 (:625),
// ragged_interp3 (:1017), ragged_pencil_interp3 (:1159).  Those tilings
// exist for the MXU and VMEM; one kernel of each kind here takes any point
// set.  Semantics: nufft_{spread,interp}{2,3}_plain in
// pyxu_tpu_torch/ops/nufft.py.
//
// Function, per batch element b, with the plan's w taps per axis:
//   spread: g[b, (i0_1 + t1) mod n1, ...] += c[b, p] * prod_a phi(z_a(t_a))
//   interp: out[b, p] = sum_{t1, ...} g[b, ...] * prod_a phi(z_a(t_a))
// with phi(z) = exp(beta (sqrt(1 - z^2) - 1)) on |z| <= 1, and
// z(t) = (t - off) * 2 / w, off = x / h - i0 in (w/2 - 1, w/2].  Values are
// complex, stored as (re, im) pairs; the grid is row-major.
//
// Design: the cuFINUFFT subproblem method.  The plan (built on the device in
// float64, ops/nufft.py plan2 / plan3) sorts the points by the bin of their
// left tap (32x32 in 2-D; in 3-D the bin of ops/nufft.py bin3, passed in)
// and splits bins of more than MAX_SUB points into subproblems, so a dense
// bin does not serialise one block.  One block per (subproblem, batch
// element):
//   spread: zero a shared subgrid, the bin plus a w-1 halo per axis; each
//           thread takes points, evaluates d*w ES weights from the stored
//           offsets (the last axes' into registers, the first axis' one tap
//           at a time) and adds the w^d products with shared atomics; then
//           one pass adds the subgrid into the global grid with global
//           atomics, wrapping every axis.
//   interp: load the bin's padded subgrid (wrapping) into shared memory;
//           each thread sums one point's w^d taps and writes the result to
//           the point's original index (the plan's permutation).  The 3-D
//           interp is this shared-memory design too, not cuFINUFFT's
//           global-memory gather.
// Strengths are read, and results written, through the permutation, so
// both take and return points in their original order.
//
// Bound (the chip_smoke.py kernel phases, M points, w taps): bytes = the
// points' plan data and values read once plus the grid written (spread) or
// read (interp) once; operations = M (w^d complex-by-real multiply-adds +
// d*w ES evaluations).  At 10^6 points, w = 7, a 2048^2 f32 grid the grid's
// 33.5 MB dominate the bytes (~13 us at 3.35 TB/s); at 2^21 points on a
// 256^3 grid the 134 MB grid (~40 us) and the 7.2e8 tap products (~40 us
// at 67 TFLOP/s) tie.  The design keeps the w^d updates of a point in
// shared memory; global traffic is one atomic pass per subgrid cell, which
// is what bounds it where many subproblems share cells (a dense bin cut
// into many subproblems, e.g. the centre of a radial 3-D set).  A 3-D
// subgrid above the 48 KB default opts in to more shared memory (up to
// 227 KB) before the launch.  No TMA, no clusters, no tuning yet.
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

// ------------------------------------------------------------------ 3-D --

struct Nu3Args {
  int n1, n2, n3;     // fine grid
  int b1, b2, b3;     // bin side per axis
  int nb2, nb3;       // bins along axes 1 and 2
  int s1, s2, s3;     // subgrid side per axis: b + w - 1
  int w, hw;          // taps per axis, w / 2
  int M;              // points
  double beta;
};

// subgrid cell (0, 0, 0) of the block's bin, in global grid indices
__device__ __forceinline__ void nu3_origin(int bin, const Nu3Args& a,
                                           int& o1, int& o2, int& o3) {
  const int q = bin / a.nb3, c3 = bin - q * a.nb3;
  const int c1 = q / a.nb2, c2 = q - c1 * a.nb2;
  o1 = c1 * a.b1 - a.hw;
  o2 = c2 * a.b2 - a.hw;
  o3 = c3 * a.b3 - a.hw;
}

__device__ __forceinline__ long nu3_global(int u, int v, int t, int o1,
                                           int o2, int o3, const Nu3Args& a) {
  return ((long)nu_wrap(o1 + u, a.n1) * a.n2 + nu_wrap(o2 + v, a.n2)) * a.n3 +
         nu_wrap(o3 + t, a.n3);
}

template <typename T>
__global__ void __launch_bounds__(NU_THREADS)
nu_spread3_kernel(const T* __restrict__ c, T* __restrict__ g,
                  const int* __restrict__ perm, const int* __restrict__ i0,
                  const T* __restrict__ off, const int* __restrict__ sub,
                  Nu3Args a) {
  extern __shared__ __align__(16) unsigned char nu_smem[];
  T* S = reinterpret_cast<T*>(nu_smem);
  const int cells = a.s1 * a.s2 * a.s3, plane = a.s2 * a.s3;
  const int first = sub[3 * blockIdx.x + 1];
  const int last = first + sub[3 * blockIdx.x + 2];
  int o1, o2, o3;
  nu3_origin(sub[3 * blockIdx.x], a, o1, o2, o3);
  c += 2 * (long)blockIdx.y * a.M;
  g += 2 * (long)blockIdx.y * a.n1 * a.n2 * a.n3;
  for (int q = threadIdx.x; q < 2 * cells; q += blockDim.x) S[q] = T(0);
  __syncthreads();

  const T beta = (T)a.beta, scale = (T)(2.0 / a.w);
  for (int j = first + threadIdx.x; j < last; j += blockDim.x) {
    const long p = perm[j];
    const T cr = c[2 * p], ci = c[2 * p + 1];
    const T off1 = off[j], off2 = off[a.M + j], off3 = off[2 * a.M + j];
    T w2[NU_MAXW], w3[NU_MAXW];
#pragma unroll
    for (int t = 0; t < NU_MAXW; ++t) {
      if (t < a.w) {
        w2[t] = nu_weight(off2, t, scale, beta);
        w3[t] = nu_weight(off3, t, scale, beta);
      }
    }
    // in [0, bin side) per axis
    const int l1 = i0[j] - o1, l2 = i0[a.M + j] - o2,
              l3 = i0[2 * a.M + j] - o3;
    for (int t1 = 0; t1 < a.w; ++t1) {
      const T v1 = nu_weight(off1, t1, scale, beta);
      T* pl = S + 2 * ((l1 + t1) * plane + l2 * a.s3 + l3);
#pragma unroll
      for (int t2 = 0; t2 < NU_MAXW; ++t2) {
        if (t2 < a.w) {
          const T v12 = v1 * w2[t2];
          T* row = pl + 2 * t2 * a.s3;
#pragma unroll
          for (int t3 = 0; t3 < NU_MAXW; ++t3) {
            if (t3 < a.w) {
              const T wt = v12 * w3[t3];
              atomicAdd(row + 2 * t3, cr * wt);
              atomicAdd(row + 2 * t3 + 1, ci * wt);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  for (int q = threadIdx.x; q < cells; q += blockDim.x) {
    const T re = S[2 * q], im = S[2 * q + 1];
    if (re == T(0) && im == T(0)) continue;
    const int u = q / plane, r = q - u * plane;
    const int v = r / a.s3, t = r - v * a.s3;
    T* dst = g + 2 * nu3_global(u, v, t, o1, o2, o3, a);
    atomicAdd(dst, re);
    atomicAdd(dst + 1, im);
  }
}

template <typename T>
__global__ void __launch_bounds__(NU_THREADS)
nu_interp3_kernel(const T* __restrict__ g, T* __restrict__ out,
                  const int* __restrict__ perm, const int* __restrict__ i0,
                  const T* __restrict__ off, const int* __restrict__ sub,
                  Nu3Args a) {
  extern __shared__ __align__(16) unsigned char nu_smem[];
  T* S = reinterpret_cast<T*>(nu_smem);
  const int cells = a.s1 * a.s2 * a.s3, plane = a.s2 * a.s3;
  const int first = sub[3 * blockIdx.x + 1];
  const int last = first + sub[3 * blockIdx.x + 2];
  int o1, o2, o3;
  nu3_origin(sub[3 * blockIdx.x], a, o1, o2, o3);
  g += 2 * (long)blockIdx.y * a.n1 * a.n2 * a.n3;
  out += 2 * (long)blockIdx.y * a.M;
  for (int q = threadIdx.x; q < cells; q += blockDim.x) {
    const int u = q / plane, r = q - u * plane;
    const int v = r / a.s3, t = r - v * a.s3;
    const T* src = g + 2 * nu3_global(u, v, t, o1, o2, o3, a);
    S[2 * q] = src[0];
    S[2 * q + 1] = src[1];
  }
  __syncthreads();

  const T beta = (T)a.beta, scale = (T)(2.0 / a.w);
  for (int j = first + threadIdx.x; j < last; j += blockDim.x) {
    const T off1 = off[j], off2 = off[a.M + j], off3 = off[2 * a.M + j];
    T w2[NU_MAXW], w3[NU_MAXW];
#pragma unroll
    for (int t = 0; t < NU_MAXW; ++t) {
      if (t < a.w) {
        w2[t] = nu_weight(off2, t, scale, beta);
        w3[t] = nu_weight(off3, t, scale, beta);
      }
    }
    const int l1 = i0[j] - o1, l2 = i0[a.M + j] - o2,
              l3 = i0[2 * a.M + j] - o3;
    T re = T(0), im = T(0);
    for (int t1 = 0; t1 < a.w; ++t1) {
      const T v1 = nu_weight(off1, t1, scale, beta);
      const T* pl = S + 2 * ((l1 + t1) * plane + l2 * a.s3 + l3);
#pragma unroll
      for (int t2 = 0; t2 < NU_MAXW; ++t2) {
        if (t2 < a.w) {
          const T v12 = v1 * w2[t2];
          const T* row = pl + 2 * t2 * a.s3;
#pragma unroll
          for (int t3 = 0; t3 < NU_MAXW; ++t3) {
            if (t3 < a.w) {
              const T wt = v12 * w3[t3];
              re += row[2 * t3] * wt;
              im += row[2 * t3 + 1] * wt;
            }
          }
        }
      }
    }
    const long p = perm[j];
    out[2 * p] = re;
    out[2 * p + 1] = im;
  }
}

template <typename T>
static int nu3_launch(bool spread, const void* src, void* dst,
                      const void* perm, const void* i0, const void* off,
                      const void* sub, int nsub, int B, const Nu3Args& a,
                      cudaStream_t stream) {
  const size_t smem = (size_t)2 * a.s1 * a.s2 * a.s3 * sizeof(T);
  const dim3 grid(nsub, B);
  if (spread) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          nu_spread3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    nu_spread3_kernel<T><<<grid, NU_THREADS, smem, stream>>>(
        (const T*)src, (T*)dst, (const int*)perm, (const int*)i0,
        (const T*)off, (const int*)sub, a);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          nu_interp3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    nu_interp3_kernel<T><<<grid, NU_THREADS, smem, stream>>>(
        (const T*)src, (T*)dst, (const int*)perm, (const int*)i0,
        (const T*)off, (const int*)sub, a);
  }
  return (int)cudaGetLastError();
}

static int nu3_dispatch(bool spread, const void* src, void* dst,
                        const void* perm, const void* i0, const void* off,
                        const void* sub, int nsub, int B, int M, int n1,
                        int n2, int n3, int b1, int b2, int b3, int nb2,
                        int nb3, int w, double beta, int f64, void* stream) {
  if (nsub < 1 || B < 1 || B > 65535 || M < 1 || n1 < 1 || n2 < 1 ||
      n3 < 1 || b1 < 1 || b2 < 1 || b3 < 1 || nb2 < 1 || nb3 < 1 || w < 2 ||
      w > NU_MAXW)
    return (int)cudaErrorInvalidValue;
  Nu3Args a;
  a.n1 = n1; a.n2 = n2; a.n3 = n3;
  a.b1 = b1; a.b2 = b2; a.b3 = b3;
  a.nb2 = nb2; a.nb3 = nb3;
  a.s1 = b1 + w - 1; a.s2 = b2 + w - 1; a.s3 = b3 + w - 1;
  a.w = w; a.hw = w / 2; a.M = M; a.beta = beta;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return nu3_launch<double>(spread, src, dst, perm, i0, off, sub, nsub, B,
                              a, s);
  return nu3_launch<float>(spread, src, dst, perm, i0, off, sub, nsub, B, a,
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

// g (B, n1, n2, n3, 2), zeroed by the caller, += the spread of the
// strengths c (B, M, 2).  perm (M,) int32, i0 (3, M) int32 and off (3, M)
// are the plan's sorted arrays; sub (nsub, 3) int32 holds (bin, first,
// count), the bin row-major over (n1/b1, nb2, nb3) bins of b1 x b2 x b3
// cells.  f64: 1 for double values and offsets, 0 for float.  Returns the
// error of the shared-memory opt-in, or cudaGetLastError() after the
// launch.
int nufft_spread3_launch(const void* c, void* g, const void* perm,
                         const void* i0, const void* off, const void* sub,
                         int nsub, int B, int M, int n1, int n2, int n3,
                         int b1, int b2, int b3, int nb2, int nb3, int w,
                         double beta, int f64, void* stream) {
  return nu3_dispatch(true, c, g, perm, i0, off, sub, nsub, B, M, n1, n2, n3,
                      b1, b2, b3, nb2, nb3, w, beta, f64, stream);
}

// out (B, M, 2) = the interp of the grid g (B, n1, n2, n3, 2) at the plan's
// points; arguments as for nufft_spread3_launch.
int nufft_interp3_launch(const void* g, void* out, const void* perm,
                         const void* i0, const void* off, const void* sub,
                         int nsub, int B, int M, int n1, int n2, int n3,
                         int b1, int b2, int b3, int nb2, int nb3, int w,
                         double beta, int f64, void* stream) {
  return nu3_dispatch(false, g, out, perm, i0, off, sub, nsub, B, M, n1, n2,
                      n3, b1, b2, b3, nb2, nb3, w, beta, f64, stream);
}

const char* nufft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
