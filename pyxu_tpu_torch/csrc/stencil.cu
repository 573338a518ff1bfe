// Separable 2-D correlation for Hopper (sm_90a): the apply and the adjoint
// of a 2-D separable Stencil, in constant or symmetric boundary mode.
//
// Replaces the Pallas TPU kernel separable_correlate2d
// (pyxu_tpu/ops/pallas_stencil.py:76; body `_kernel` :32, call :98), which
// computes the constant-mode apply only, and beyond it what
// pyxu_tpu/operator/linop/stencil.py Stencil.apply / Stencil.adjoint compute
// in symmetric mode.  Semantics: separable_correlate2d_plain in
// pyxu_tpu_torch/ops/stencil.py.
//
// Apply, per image of a batch:
//   y[i,j] = sum_a sum_b k0[a] k1[b] x[m_H(i + a - c0), m_W(j + b - c1)]
// with m the boundary map: zero outside the image (constant) or the numpy
// "symmetric" reflection.  The adjoint is the full correlation with the
// flipped taps followed by the pad's fold-back.  The wrapper passes flipped
// taps and mirrored centres (L-1-c), so the kernel runs one correlation
// with a zero boundary, and in symmetric mode (`fold`) adds per axis the two
// reflected ghost terms by global index: output s also gathers the full
// correlation at -1-s and 2n-1-s.  Pad widths never exceed the axis length,
// so one reflection or fold suffices.
//
// Bound: one read and one write of each pixel.  At 2160x3840 f32 that is
// 66.4 MB, 19.8 us at 3.35 TB/s; the 2(L0+L1) flops per pixel (36 for 9+9
// taps) take 4.5 us at 67 TFLOP/s, so the kernel is bytes-bound.  Design
// against that bound: one block per 32x64 output tile loads its window (the
// tile and a halo of h = max(c, L-1-c) per side, boundary map applied) into
// shared memory once, runs the vertical pass into a shared intermediate,
// then the horizontal pass, and writes each output pixel once.  Only the
// halo is read twice, mostly from L2.  No TMA, no wgmma.
//
// A block loads only the window its outputs reach, (rows + 2h) x (cols + 2h)
// for a tile of rows x cols outputs: its indices lie in [-h, n + h) per
// axis, so with h <= n one reflection lands inside the image and no read
// leaves the image's plane.  The fold needs every reflected index inside
// that window, which holds when the tile is at least h on each axis:
// ST_MAXL taps give h <= ST_MAXL - 1.
//
// Test builds define ST_COUNT_STRAY_READS: a window element whose index
// falls outside the plane is then counted and loaded as zero instead of
// read, and stencil_stray_reads() returns the count.

#include <cuda_runtime.h>

#define ST_MAXL 32
// tap count of the unrolled path: for the workloads' 9+9-tap blur it takes
// less time than the runtime-count path (PERF.md, section 6)
#define ST_FAST_L 9
// output tile (rows x cols) and threads (cols x rows) of a block; the
// tile must hold the halo (ST_TR, ST_TC >= ST_MAXL - 1); ops/stencil.py
// mirrors the tap limit (_MAX_TAPS)
#define ST_TR 32
#define ST_TC 64
#define ST_TX 64
#define ST_TY 4

#ifdef ST_COUNT_STRAY_READS
__device__ unsigned long long st_stray_reads;
#endif

struct StArgs {
  double k0[ST_MAXL];
  double k1[ST_MAXL];
  int L0, L1, c0, c1;  // tap counts and centres (rows, cols)
  int h0, h1;          // window halo per side (rows, cols)
  int H, W;
  int reflect;         // load outside the image through the symmetric map
  int fold;            // add the symmetric fold-back's ghost terms
};

__device__ __forceinline__ int st_reflect(int q, int n) {
  return q < 0 ? -1 - q : (q >= n ? 2 * n - 1 - q : q);
}

// One output tile.  FOLD: this block may gather ghost terms.  LK: the tap
// count of both axes when fixed at compile time, 0 for a runtime count.
template <typename T, bool FOLD, int LK>
__device__ __forceinline__ void st_tile(const T* __restrict__ x,
                                        T* __restrict__ y, const StArgs& a,
                                        const T* k0, const T* k1, T* S,
                                        T* V) {
  const int H = a.H, W = a.W;
  const int L0 = LK ? LK : a.L0, L1 = LK ? LK : a.L1;
  const int c0 = a.c0, c1 = a.c1, h0 = a.h0, h1 = a.h1;
  const int r0 = blockIdx.y * ST_TR, q0 = blockIdx.x * ST_TC;
  const int rows = min(ST_TR, H - r0), cols = min(ST_TC, W - q0);
  // window: global (wr, wq) is local (0, 0); NR x NC used, row pitch P
  const int wr = r0 - h0, wq = q0 - h1;
  const int NR = rows + 2 * h0, NC = cols + 2 * h1, P = ST_TC + 2 * h1;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int u = ty; u < NR; u += ST_TY) {
    int g = wr + u;
    bool rin = g >= 0 && g < H;
    if (!rin && a.reflect) {
      g = st_reflect(g, H);
      rin = true;
    }
    for (int v = tx; v < NC; v += ST_TX) {
      int gq = wq + v;
      bool cin = gq >= 0 && gq < W;
      if (!cin && a.reflect) {
        gq = st_reflect(gq, W);
        cin = true;
      }
      bool in = rin && cin;
#ifdef ST_COUNT_STRAY_READS
      if (in && (g < 0 || g >= H || gq < 0 || gq >= W)) {
        atomicAdd(&st_stray_reads, 1ull);
        in = false;
      }
#endif
      S[u * P + v] = in ? x[(long)g * W + gq] : T(0);
    }
  }
  __syncthreads();

  // vertical pass over every used window column, for the tile's rows
  for (int i = ty; i < rows; i += ST_TY) {
    const int s = r0 + i;
    for (int v = tx; v < NC; v += ST_TX) {
      const T* src = S + (i + h0 - c0) * P + v;
      T acc = T(0);
#pragma unroll
      for (int t = 0; t < L0; ++t) acc += k0[t] * src[t * P];
      if constexpr (FOLD) {
        for (int t = 0; t < L0; ++t) {
          const int lo = -1 - s + t - c0, hi = 2 * H - 1 - s + t - c0;
          if (lo >= 0) acc += k0[t] * S[(lo - wr) * P + v];
          if (hi < H) acc += k0[t] * S[(hi - wr) * P + v];
        }
      }
      V[i * P + v] = acc;
    }
  }
  __syncthreads();

  // horizontal pass; each output pixel is written once
  for (int i = ty; i < rows; i += ST_TY) {
    const T* row = V + i * P;
    T* out = y + (long)(r0 + i) * W;
    for (int j = tx; j < cols; j += ST_TX) {
      const int q = q0 + j;
      const T* src = row + j + h1 - c1;
      T acc = T(0);
#pragma unroll
      for (int t = 0; t < L1; ++t) acc += k1[t] * src[t];
      if constexpr (FOLD) {
        for (int t = 0; t < L1; ++t) {
          const int lo = -1 - q + t - c1, hi = 2 * W - 1 - q + t - c1;
          if (lo >= 0) acc += k1[t] * row[lo - wq];
          if (hi < W) acc += k1[t] * row[hi - wq];
        }
      }
      out[q] = acc;
    }
  }
}

template <typename T, int LK>
__global__ void __launch_bounds__(ST_TX * ST_TY)
st_kernel(const T* __restrict__ x, T* __restrict__ y, StArgs a) {
  extern __shared__ __align__(16) unsigned char st_smem[];
  __shared__ T k0[ST_MAXL], k1[ST_MAXL];
  const int tid = threadIdx.y * ST_TX + threadIdx.x;
  if (tid < ST_MAXL) {
    k0[tid] = (T)a.k0[tid];
    k1[tid] = (T)a.k1[tid];
  }
  __syncthreads();
  const long plane = (long)a.H * a.W;
  x += blockIdx.z * plane;
  y += blockIdx.z * plane;
  T* S = reinterpret_cast<T*>(st_smem);
  T* V = S + (ST_TR + 2 * a.h0) * (ST_TC + 2 * a.h1);
  // ghost terms reach only tiles within h of an edge
  const int r0 = blockIdx.y * ST_TR, q0 = blockIdx.x * ST_TC;
  const bool edge = r0 < a.h0 || r0 + ST_TR > a.H - a.h0 || q0 < a.h1 ||
                    q0 + ST_TC > a.W - a.h1;
  if (a.fold && edge)
    st_tile<T, true, LK>(x, y, a, k0, k1, S, V);
  else
    st_tile<T, false, LK>(x, y, a, k0, k1, S, V);
}

static size_t st_smem_bytes(const StArgs& a, size_t elem) {
  const size_t P = ST_TC + 2 * a.h1;
  return ((ST_TR + 2 * a.h0) * P + ST_TR * P) * elem;
}

template <typename T, int LK>
static int st_launch(const void* x, void* y, int B, const StArgs& a,
                     cudaStream_t stream) {
  const size_t smem = st_smem_bytes(a, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      st_kernel<T, LK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.W + ST_TC - 1) / ST_TC, (a.H + ST_TR - 1) / ST_TR, B);
  st_kernel<T, LK><<<grid, dim3(ST_TX, ST_TY), smem, stream>>>(
      (const T*)x, (T*)y, a);
  return (int)cudaGetLastError();
}

template <typename T>
static int st_launch_taps(const void* x, void* y, int B, const StArgs& a,
                          cudaStream_t s) {
  if (a.L0 == ST_FAST_L && a.L1 == ST_FAST_L)
    return st_launch<T, ST_FAST_L>(x, y, B, a, s);
  return st_launch<T, 0>(x, y, B, a, s);
}

extern "C" {

// y = one separable correlation of each of the B contiguous (H, W) images
// of x.  f64: 1 for double storage, 0 for float.  reflect / fold as in
// StArgs.  Returns cudaGetLastError() after the launch.
int stencil_launch(const void* x, void* y, int B, int H, int W, int f64,
                   const double* k0, int L0, int c0, const double* k1, int L1,
                   int c1, int reflect, int fold, void* stream) {
  if (L0 < 1 || L0 > ST_MAXL || L1 < 1 || L1 > ST_MAXL || c0 < 0 ||
      c0 >= L0 || c1 < 0 || c1 >= L1 || B < 1 || B > 65535 || H < 1 ||
      W < 1)
    return (int)cudaErrorInvalidValue;
  StArgs a;
  for (int t = 0; t < ST_MAXL; ++t) {
    a.k0[t] = t < L0 ? k0[t] : 0.0;
    a.k1[t] = t < L1 ? k1[t] : 0.0;
  }
  a.L0 = L0; a.L1 = L1; a.c0 = c0; a.c1 = c1;
  a.h0 = c0 > L0 - 1 - c0 ? c0 : L0 - 1 - c0;
  a.h1 = c1 > L1 - 1 - c1 ? c1 : L1 - 1 - c1;
  a.H = H; a.W = W;
  a.reflect = reflect; a.fold = fold;
  // one reflection must reach back into the image
  if ((reflect || fold) && (a.h0 > H || a.h1 > W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64) return st_launch_taps<double>(x, y, B, a, s);
  return st_launch_taps<float>(x, y, B, a, s);
}

const char* stencil_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#ifdef ST_COUNT_STRAY_READS
// stray window reads counted since the last call (then reset), or -1 when
// the device symbol cannot be read
long long stencil_stray_reads() {
  unsigned long long n = 0, zero = 0;
  if (cudaMemcpyFromSymbol(&n, st_stray_reads, sizeof n) != cudaSuccess ||
      cudaMemcpyToSymbol(st_stray_reads, &zero, sizeof zero) != cudaSuccess)
    return -1;
  return (long long)n;
}
#endif

}  // extern "C"
