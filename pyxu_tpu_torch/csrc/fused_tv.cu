// Fused Condat-Vu TV-deconvolution iterations for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of pyxu_tpu/ops/fused_tv.py:
//   * tv_step_kernel  <- tv_step_pallas  (fused_tv.py:390; bodies `kernel`
//     :682 and `kernel_g` :749 compute one function, so they become one
//     kernel here): one iteration per pass;
//   * tv_stepk_kernel <- tv_stepk_pallas (fused_tv.py:926; body :1048):
//     n_steps exact iterations per pass.
//
// One iteration on (x, z = (z0, z1), b):
//   x+ = x - tau (cst K^T K x + b + D^T z)
//   z+ = L21 Fenchel prox of z + sigma D (2 x+ - x), as z * min(lam rsqrt(|z|^2), 1)
//   (x, z) <- (x, z) + rho ((x+, z+) - (x, z))
// with K a separable correlation (pad + valid corr, boundary symmetric or
// constant) and D the forward-difference gradient.  Storage of x and z is
// f32 or bf16 each; arithmetic is f32.  Semantics: tv_step_ref in
// pyxu_tpu_torch/ops/fused_tv.py (= tv_step_xla of the JAX package).
//
// Bound: one iteration must read x, z0, z1, b and write x, z0, z1 — 7 f32
// frames, 232 MB at 2160x3840, 69 us at 3.35 TB/s; about 100 flops/px, so
// the step is memory-bound on paper.  The K-step pass moves the same 7
// frames for K iterations.  Design against that bound: one output tile per
// block; the block loads x and z once, with an apron of K*g pixels per side
// (g = max(2h, 1), h = max(lo, hi) of the blur taps per axis: K^T K reaches
// 2h, D^T and D one), into shared memory, runs all K levels there — level j
// recomputes the values level j+1 reads on an apron shrinking by g per
// level — and writes only its tile.  Level state is rounded through the
// storage dtype between levels, so the result equals K single-step passes
// up to float reassociation.  The apron recomputation costs operations,
// not bytes.
//
// What limits this simple form is issued instructions, not bytes.  So a
// block whose whole window lies inside the image (most of them) takes a
// path with no boundary tests, and with the tap loops unrolled when both
// axes have TV_FAST_L taps; regions are walked without a division per
// element.  Blocks near the edge take the general path.  No TMA, no wgmma.
//
// Boundary rules (general path) are applied by GLOBAL index: symmetric
// reflection for K x, the fold-back of the adjoint, and the gradient's edge
// rules.  Every stage's window is its consumer's window widened by h and
// clamped to the image, so every reflected index lands inside data the
// block holds.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>

#define TV_MAXL 32
#define TV_FAST_L 9        // tap count of the unrolled interior path
// threads and output tile (rows x cols) of a block; ops/fused_tv.py
// mirrors the tiles (_TILES)
#ifndef TV_THREADS
#define TV_THREADS 256     // single step: several blocks share an SM
#endif
#ifndef TV_THREADS_K
#define TV_THREADS_K 1024  // K-step: one block per SM (shared memory)
#endif
#ifndef TV_TR
#define TV_TR 32
#define TV_TC 32
#endif
#ifndef TV_TR_K
#define TV_TR_K 48
#define TV_TC_K 64
#endif

struct TVArgs {
  float k0[TV_MAXL];
  float k1[TV_MAXL];
  int L0, L1, c0, c1;   // tap counts and centres (rows, cols)
  int h0, h1;           // per-stage halo max(lo, hi) (rows, cols)
  int g0, g1;           // apron one level adds per side, max(2h, 1)
  int sym_k, sym_d;     // boundary mode of K and of D: 1 symmetric, 0 constant
  float cst, lam, tau, sigma, rho;
  int H, W;
};

__device__ __forceinline__ float tv_ld(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float tv_ld(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void tv_st(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void tv_st(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float tv_round(float v, const float*) { return v; }
__device__ __forceinline__ float tv_round(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Index of padded position q along an axis of length n: itself inside,
// reflected (numpy "symmetric") outside, -1 for a constant-mode zero.
__device__ __forceinline__ int tv_src(int q, int n, int sym) {
  if (q >= 0 && q < n) return q;
  if (!sym) return -1;
  return q < 0 ? -1 - q : 2 * n - 1 - q;
}

// f(r, q) for every (r, q) of [r0, r1) x [q0, q1): the block's threads
// stride over the flattened region, one division per call.
template <typename F>
__device__ __forceinline__ void tv_region(int r0, int r1, int q0, int q1,
                                          F&& f) {
  const int nq = q1 - q0;
  if (nq <= 0 || r1 <= r0) return;
  const int n = blockDim.x, dr = n / nq, dq = n % nq;
  int r = r0 + (int)threadIdx.x / nq, q = q0 + (int)threadIdx.x % nq;
  while (r < r1) {
    f(r, q);
    r += dr;
    q += dq;
    if (q >= q1) {
      q -= nq;
      ++r;
    }
  }
}

// K levels of one TR x TC tile.  EDGE: the window may cross the image edge
// (general path); else no boundary rule can apply inside it.  LK: the tap
// count of both axes when fixed at compile time, 0 for a runtime count.
template <typename TX, typename TZ, int TR, int TC, bool EDGE, int LK>
__device__ __forceinline__ void tv_levels(
    const TX* __restrict__ x, const TZ* __restrict__ z,
    const float* __restrict__ b, TX* __restrict__ xo, TZ* __restrict__ zo,
    const TVArgs& a, const int K) {
  extern __shared__ float smem[];
  const int H = a.H, W = a.W;
  const long HW = (long)H * W;
  const int L0 = LK ? LK : a.L0, L1 = LK ? LK : a.L1;
  const int c0 = a.c0, c1 = a.c1;
  const int r0 = blockIdx.y * TR, q0 = blockIdx.x * TC;
  // window: global (wr, wq) is local (0, 0); NR rows of pitch P
  const int wr = r0 - K * a.g0, wq = q0 - K * a.g1;
  const int NR = TR + 2 * K * a.g0 + 1, P = TC + 2 * K * a.g1 + 1;
  float* X = smem;           // x state of the current level
  float* Z0 = X + NR * P;    // z state, component 0 (rows)
  float* Z1 = Z0 + NR * P;   // z state, component 1 (cols)
  float* S = Z1 + NR * P;    // row-stage scratch
  float* Y = S + NR * P;     // K x, then x+
#define AT(A, r, q) A[((r) - wr) * P + ((q) - wq)]

  // load the window (clipped to the image)
  tv_region(max(0, wr), min(H, wr + NR), max(0, wq), min(W, wq + P),
            [&](int r, int q) {
              const long g = (long)r * W + q;
              AT(X, r, q) = tv_ld(x, g);
              AT(Z0, r, q) = tv_ld(z, g);
              AT(Z1, r, q) = tv_ld(z, HW + g);
            });
  __syncthreads();

  for (int j = 1; j <= K; ++j) {
    const int e0 = (K - j) * a.g0, e1 = (K - j) * a.g1;
    const bool last = j == K;
    // x+ region (one extra row/col for the forward difference of v),
    // z+ region, K x region, row-stage column range
    const int xr0 = max(0, r0 - e0), xr1 = min(H, r0 + TR + e0 + 1);
    const int xq0 = max(0, q0 - e1), xq1 = min(W, q0 + TC + e1 + 1);
    const int zr1 = min(H, r0 + TR + e0), zq1 = min(W, q0 + TC + e1);
    const int yr0 = max(0, xr0 - a.h0), yr1 = min(H, xr1 + a.h0);
    const int yq0 = max(0, xq0 - a.h1), yq1 = min(W, xq1 + a.h1);
    const int sq0 = max(0, yq0 - a.h1), sq1 = min(W, yq1 + a.h1);

    // A: S = K's row stage (pad + valid corr along rows) on [yr) x [sq)
    tv_region(yr0, yr1, sq0, sq1, [&](int r, int q) {
      float acc = 0.f;
      if constexpr (EDGE) {
        for (int t = 0; t < L0; ++t) {
          const int s = tv_src(r + t - c0, H, a.sym_k);
          if (s >= 0) acc += a.k0[t] * AT(X, s, q);
        }
      } else {
        const float* src = &AT(X, r - c0, q);
#pragma unroll
        for (int t = 0; t < L0; ++t) acc += a.k0[t] * src[t * P];
      }
      AT(S, r, q) = acc;
    });
    __syncthreads();
    // B: Y = K x (column stage) on [yr) x [yq)
    tv_region(yr0, yr1, yq0, yq1, [&](int r, int q) {
      float acc = 0.f;
      if constexpr (EDGE) {
        for (int t = 0; t < L1; ++t) {
          const int s = tv_src(q + t - c1, W, a.sym_k);
          if (s >= 0) acc += a.k1[t] * AT(S, r, s);
        }
      } else {
        const float* src = &AT(S, r, q - c1);
#pragma unroll
        for (int t = 0; t < L1; ++t) acc += a.k1[t] * src[t];
      }
      AT(Y, r, q) = acc;
    });
    __syncthreads();
    // C: S = K^T's column stage of Y on [yr) x [xq): full correlation with
    // the flipped taps plus the symmetric fold-back of both ghost regions
    tv_region(yr0, yr1, xq0, xq1, [&](int r, int q) {
      float acc = 0.f;
      if constexpr (EDGE) {
        for (int t = 0; t < L1; ++t) {
          const int s = q + c1 - t;
          if (s >= 0 && s < W) acc += a.k1[t] * AT(Y, r, s);
          if (a.sym_k) {
            const int s_lo = -1 - q + c1 - t;
            const int s_hi = 2 * W - 1 - q + c1 - t;
            if (s_lo >= 0 && s_lo < W) acc += a.k1[t] * AT(Y, r, s_lo);
            if (s_hi >= 0 && s_hi < W) acc += a.k1[t] * AT(Y, r, s_hi);
          }
        }
      } else {
        const float* src = &AT(Y, r, q + c1);
#pragma unroll
        for (int t = 0; t < L1; ++t) acc += a.k1[t] * src[-t];
      }
      AT(S, r, q) = acc;
    });
    __syncthreads();
    // D: x+ on [xr) x [xq), into Y
    tv_region(xr0, xr1, xq0, xq1, [&](int p, int q) {
      float ktk = 0.f;
      if constexpr (EDGE) {
        for (int t = 0; t < L0; ++t) {
          const int s = p + c0 - t;
          if (s >= 0 && s < H) ktk += a.k0[t] * AT(S, s, q);
          if (a.sym_k) {
            const int s_lo = -1 - p + c0 - t;
            const int s_hi = 2 * H - 1 - p + c0 - t;
            if (s_lo >= 0 && s_lo < H) ktk += a.k0[t] * AT(S, s_lo, q);
            if (s_hi >= 0 && s_hi < H) ktk += a.k0[t] * AT(S, s_hi, q);
          }
        }
      } else {
        const float* src = &AT(S, p + c0, q);
#pragma unroll
        for (int t = 0; t < L0; ++t) ktk += a.k0[t] * src[-t * P];
      }
      const float gf = a.cst * ktk + b[(long)p * W + q];
      // D^T z: d[0] = -g[0], d[i] = g[i-1] - g[i]; symmetric adds g[n-1]
      const float z0c = AT(Z0, p, q), z1c = AT(Z1, p, q);
      float dt0, dt1;
      if constexpr (EDGE) {
        dt0 = (p > 0 ? AT(Z0, p - 1, q) : 0.f) - z0c;
        if (a.sym_d && p == H - 1) dt0 += z0c;
        dt1 = (q > 0 ? AT(Z1, p, q - 1) : 0.f) - z1c;
        if (a.sym_d && q == W - 1) dt1 += z1c;
      } else {
        dt0 = AT(Z0, p - 1, q) - z0c;
        dt1 = AT(Z1, p, q - 1) - z1c;
      }
      AT(Y, p, q) = AT(X, p, q) - a.tau * (gf + dt0 + dt1);
    });
    __syncthreads();
    // E: z+ on [xr0, zr1) x [xq0, zq1), in place
    tv_region(xr0, zr1, xq0, zq1, [&](int p, int q) {
      const float v = 2.f * AT(Y, p, q) - AT(X, p, q);
      float u0, u1;
      if (EDGE && p == H - 1) u0 = a.sym_d ? 0.f : -v;
      else u0 = 2.f * AT(Y, p + 1, q) - AT(X, p + 1, q) - v;
      if (EDGE && q == W - 1) u1 = a.sym_d ? 0.f : -v;
      else u1 = 2.f * AT(Y, p, q + 1) - AT(X, p, q + 1) - v;
      const float z0c = AT(Z0, p, q), z1c = AT(Z1, p, q);
      const float t0 = z0c + a.sigma * u0, t1 = z1c + a.sigma * u1;
      const float fac =
          fminf(a.lam * rsqrtf(fmaxf(t0 * t0 + t1 * t1, FLT_MIN)), 1.f);
      float n0 = t0 * fac, n1 = t1 * fac;
      if (a.rho != 1.f) {
        n0 = z0c + a.rho * (n0 - z0c);
        n1 = z1c + a.rho * (n1 - z1c);
      }
      if (!last) {
        n0 = tv_round(n0, z);
        n1 = tv_round(n1, z);
      }
      AT(Z0, p, q) = n0;
      AT(Z1, p, q) = n1;
    });
    __syncthreads();
    // F: x <- relaxed x+ on [xr) x [xq), in place
    tv_region(xr0, xr1, xq0, xq1, [&](int p, int q) {
      const float xc = AT(X, p, q), xp = AT(Y, p, q);
      float xn = a.rho != 1.f ? xc + a.rho * (xp - xc) : xp;
      if (!last) xn = tv_round(xn, x);
      AT(X, p, q) = xn;
    });
    __syncthreads();
  }

  // store the tile; the storage dtype rounds once here
  tv_region(r0, min(H, r0 + TR), q0, min(W, q0 + TC), [&](int r, int q) {
    const long g = (long)r * W + q;
    tv_st(xo, g, AT(X, r, q));
    tv_st(zo, g, AT(Z0, r, q));
    tv_st(zo, HW + g, AT(Z1, r, q));
  });
#undef AT
}

// Whether this block's K-level window lies inside the image.
__device__ __forceinline__ bool tv_interior(const TVArgs& a, int K, int TR,
                                            int TC) {
  const int wr = blockIdx.y * TR - K * a.g0, wq = blockIdx.x * TC - K * a.g1;
  return wr >= 0 && wq >= 0 && wr + TR + 2 * K * a.g0 + 1 <= a.H &&
         wq + TC + 2 * K * a.g1 + 1 <= a.W;
}

template <typename TX, typename TZ, int LK>
__global__ void __launch_bounds__(TV_THREADS)
tv_step_kernel(const TX* __restrict__ x, const TZ* __restrict__ z,
               const float* __restrict__ b, TX* __restrict__ xo,
               TZ* __restrict__ zo, TVArgs a) {
  if (tv_interior(a, 1, TV_TR, TV_TC))
    tv_levels<TX, TZ, TV_TR, TV_TC, false, LK>(x, z, b, xo, zo, a, 1);
  else
    tv_levels<TX, TZ, TV_TR, TV_TC, true, 0>(x, z, b, xo, zo, a, 1);
}

template <typename TX, typename TZ, int LK>
__global__ void __launch_bounds__(TV_THREADS_K)
tv_stepk_kernel(const TX* __restrict__ x, const TZ* __restrict__ z,
                const float* __restrict__ b, TX* __restrict__ xo,
                TZ* __restrict__ zo, TVArgs a, int n_steps) {
  if (tv_interior(a, n_steps, TV_TR_K, TV_TC_K))
    tv_levels<TX, TZ, TV_TR_K, TV_TC_K, false, LK>(x, z, b, xo, zo, a,
                                                   n_steps);
  else
    tv_levels<TX, TZ, TV_TR_K, TV_TC_K, true, 0>(x, z, b, xo, zo, a,
                                                 n_steps);
}

static size_t tv_smem_bytes(const TVArgs& a, int K, int TR, int TC) {
  const size_t nr = TR + 2 * K * a.g0 + 1;
  const size_t nc = TC + 2 * K * a.g1 + 1;
  return 5 * nr * nc * sizeof(float);
}

template <typename TX, typename TZ, int LK>
static int tv_launch(const void* x, const void* z, const void* b, void* xo,
                     void* zo, const TVArgs& a, int K, cudaStream_t stream) {
  cudaError_t err;
  if (K == 1) {
    const size_t smem = tv_smem_bytes(a, 1, TV_TR, TV_TC);
    const dim3 grid((a.W + TV_TC - 1) / TV_TC, (a.H + TV_TR - 1) / TV_TR);
    err = cudaFuncSetAttribute(tv_step_kernel<TX, TZ, LK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    tv_step_kernel<TX, TZ, LK><<<grid, TV_THREADS, smem, stream>>>(
        (const TX*)x, (const TZ*)z, (const float*)b, (TX*)xo, (TZ*)zo, a);
  } else {
    const size_t smem = tv_smem_bytes(a, K, TV_TR_K, TV_TC_K);
    const dim3 grid((a.W + TV_TC_K - 1) / TV_TC_K,
                    (a.H + TV_TR_K - 1) / TV_TR_K);
    err = cudaFuncSetAttribute(tv_stepk_kernel<TX, TZ, LK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    tv_stepk_kernel<TX, TZ, LK><<<grid, TV_THREADS_K, smem, stream>>>(
        (const TX*)x, (const TZ*)z, (const float*)b, (TX*)xo, (TZ*)zo, a, K);
  }
  return (int)cudaGetLastError();
}

template <typename TX, typename TZ>
static int tv_launch_taps(const void* x, const void* z, const void* b,
                          void* xo, void* zo, const TVArgs& a, int K,
                          cudaStream_t s) {
  if (a.L0 == TV_FAST_L && a.L1 == TV_FAST_L)
    return tv_launch<TX, TZ, TV_FAST_L>(x, z, b, xo, zo, a, K, s);
  return tv_launch<TX, TZ, 0>(x, z, b, xo, zo, a, K, s);
}

static int tv_dispatch(const void* x, const void* z, const void* b, void* xo,
                       void* zo, int H, int W, int x_bf16, int z_bf16,
                       const float* k0, int L0, int c0, const float* k1,
                       int L1, int c1, int sym_k, int sym_d, float cst,
                       float lam, float tau, float sigma, float rho, int K,
                       void* stream) {
  if (L0 < 1 || L0 > TV_MAXL || L1 < 1 || L1 > TV_MAXL || K < 1 ||
      c0 < 0 || c0 >= L0 || c1 < 0 || c1 >= L1)
    return (int)cudaErrorInvalidValue;
  TVArgs a;
  for (int t = 0; t < TV_MAXL; ++t) {
    a.k0[t] = t < L0 ? k0[t] : 0.f;
    a.k1[t] = t < L1 ? k1[t] : 0.f;
  }
  a.L0 = L0; a.L1 = L1; a.c0 = c0; a.c1 = c1;
  a.h0 = c0 > L0 - 1 - c0 ? c0 : L0 - 1 - c0;
  a.h1 = c1 > L1 - 1 - c1 ? c1 : L1 - 1 - c1;
  a.g0 = a.h0 > 0 ? 2 * a.h0 : 1;
  a.g1 = a.h1 > 0 ? 2 * a.h1 : 1;
  a.sym_k = sym_k; a.sym_d = sym_d;
  a.cst = cst; a.lam = lam; a.tau = tau; a.sigma = sigma; a.rho = rho;
  a.H = H; a.W = W;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    if (z_bf16)
      return tv_launch_taps<__nv_bfloat16, __nv_bfloat16>(x, z, b, xo, zo, a, K, s);
    return tv_launch_taps<__nv_bfloat16, float>(x, z, b, xo, zo, a, K, s);
  }
  if (z_bf16) return tv_launch_taps<float, __nv_bfloat16>(x, z, b, xo, zo, a, K, s);
  return tv_launch_taps<float, float>(x, z, b, xo, zo, a, K, s);
}

extern "C" {

// One iteration per pass.  Returns cudaGetLastError() after the launch.
int tv_step_launch(const void* x, const void* z, const void* b, void* xo,
                   void* zo, int H, int W, int x_bf16, int z_bf16,
                   const float* k0, int L0, int c0, const float* k1, int L1,
                   int c1, int sym_k, int sym_d, float cst, float lam,
                   float tau, float sigma, float rho, void* stream) {
  return tv_dispatch(x, z, b, xo, zo, H, W, x_bf16, z_bf16, k0, L0, c0, k1,
                     L1, c1, sym_k, sym_d, cst, lam, tau, sigma, rho, 1,
                     stream);
}

// n_steps (>= 2) iterations per pass.  Returns cudaGetLastError().
int tv_stepk_launch(const void* x, const void* z, const void* b, void* xo,
                    void* zo, int H, int W, int x_bf16, int z_bf16,
                    const float* k0, int L0, int c0, const float* k1, int L1,
                    int c1, int sym_k, int sym_d, float cst, float lam,
                    float tau, float sigma, float rho, int n_steps,
                    void* stream) {
  if (n_steps < 2) return (int)cudaErrorInvalidValue;
  return tv_dispatch(x, z, b, xo, zo, H, W, x_bf16, z_bf16, k0, L0, c0, k1,
                     L1, c1, sym_k, sym_d, cst, lam, tau, sigma, rho, n_steps,
                     stream);
}

const char* tv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
