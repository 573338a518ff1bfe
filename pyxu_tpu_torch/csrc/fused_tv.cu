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
// The body is designed against shared-memory traffic, barriers and the
// latency of device memory:
//  * Interior blocks (the K-level window inside the image: no boundary
//    rule can apply) take K^T K in the normal form of the JAX package's
//    `kernel_g` (_normal_op_data): K = R o C is separable, so
//    K^T K = (R^T R)(C^T C), each factor one symmetric band of 2L-1 taps,
//    g = correlate(k, k, "full"), computed in double on the host and
//    rounded once.  Two tap passes a level instead of four: g0 down the
//    rows into S, then g1 along the columns, fused with x+.
//  * Register-sliding taps: in each tap pass a thread owns a strip of
//    consecutive outputs along the tap axis (TV_R down the rows, TV_RC
//    along the columns) and reads the R + 2L - 2 inputs the strip needs
//    once, so a tap costs an FMA and no shared load.  Strips down the
//    rows are laid across a warp by column, strips along the columns by
//    row (the pitch is odd), so a warp's loads hit 32 banks.  The z+ stage
//    takes the same column strips.
//  * No relaxation pass: at rho = 1 with f32 x the x buffer and the x+
//    buffer swap roles between levels; otherwise the z+ stage writes the
//    relaxed, rounded x into the free scratch, which then swaps with x.
//    Three barriers a level on interior blocks (six before).
//  * f32 windows and b arrive by cp.async, so a thread's whole share is in
//    flight at once; b lands where x+ will overwrite it, level 1's with the
//    window and later levels' while pass 1 runs.  bf16 state is widened
//    through registers.  The tiles are small enough (31x31 at K = 1, 48 KB)
//    for several blocks to share an SM, so one block's loads overlap
//    another's taps.
// Blocks whose window crosses the image edge keep the four-stage form
// (row, column, column adjoint, row adjoint of K) with the boundary rules
// applied by GLOBAL index: symmetric reflection for K x, the fold-back of
// the adjoint, and the gradient's edge rules; indices in [h, n - h), which
// no rule reaches, take unrolled loops.  Every stage's window is its
// consumer's window widened by h and clamped to the image, so every
// reflected index lands inside data the block holds.  No TMA, no wgmma:
// this is a stencil, not a product.
//
// Depth: on the H100 at 2160x3840 with the 9-tap blur, one level a pass
// (tv_step) costs least an iteration, so the TV path takes K = 1
// (ops/fused_tv.py N_STEPS; chip_smoke.py's K sweep, PERF.md).  A build
// with -DTV_PHASE_CLOCKS records each phase's SM clocks
// (bench_fused_tv_tiles.py --phases).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>

#include <type_traits>

#define TV_MAXL 32
#define TV_MAXG (2 * TV_MAXL - 1)   // normal-form taps an axis
#define TV_FAST_L 9        // tap count of the unrolled interior path
#define TV_R 8             // outputs of a strip down the rows (pass 1)
#define TV_RC 4            // outputs of a strip along the columns (pass 2,
                           // z+): small tiles then keep every thread busy
// threads of a block (registers are capped so that 1024 threads fit an
// SM), and output tile (rows x cols) a block takes at each depth K (K >= 4
// take K = 4's), chosen by bench_fused_tv_tiles.py on the H100: 8m - 1 rows
// and columns, so that the x+ region (tile + 1) fills whole strips;
// ops/fused_tv.py mirrors the tiles (_TILES)
#ifndef TV_THREADS
#define TV_THREADS 256     // single step
#endif
#ifndef TV_THREADS_K
#define TV_THREADS_K 512   // K-step
#endif
#ifndef TV_TR_1
#define TV_TR_1 31
#define TV_TC_1 31
#endif
#ifndef TV_TR_2
#define TV_TR_2 31
#define TV_TC_2 47
#endif
#ifndef TV_TR_3
#define TV_TR_3 47
#define TV_TC_3 63
#endif
#ifndef TV_TR_4
#define TV_TR_4 31
#define TV_TC_4 47
#endif

struct TVArgs {
  float k0[TV_MAXL];
  float k1[TV_MAXL];
  float g0[TV_MAXG];    // normal-form taps, g[d + L - 1] for d in [1-L, L-1]
  float g1[TV_MAXG];
  int L0, L1, c0, c1;   // tap counts and centres (rows, cols)
  int h0, h1;           // per-stage halo max(lo, hi) (rows, cols)
  int ap0, ap1;         // apron one level adds per side, max(2h, 1)
  int sym_k, sym_d;     // boundary mode of K and of D: 1 symmetric, 0 constant
  float cst, lam, tau, sigma, rho;
  int H, W;
  int TR, TC;           // output tile of a block
};

__device__ __forceinline__ void tv_st(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void tv_st(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
#ifdef TV_PHASE_CLOCKS
// Per-phase clock sums of interior (0-4) and edge (8-12) blocks, and the
// blocks counted (7, 15); a build with -DTV_PHASE_CLOCKS only.
__device__ unsigned long long tv_clocks[16];
#endif

// One window cell into shared memory: f32 by an asynchronous copy (no
// register waits for it, so a thread's whole share of the window is in
// flight at once; tv_fill_wait ends it), bf16 widened through a register.
__device__ __forceinline__ void tv_fill(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void tv_fill(float* dst, const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}
__device__ __forceinline__ void tv_fill_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// f(r, q) for every (r, q) of [r0, r1) x [q0, q1): a warp to a row, its
// lanes along it (copies between device and shared memory).
template <typename F>
__device__ __forceinline__ void tv_rows(int r0, int r1, int q0, int q1,
                                        F&& f) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = r0 + (int)(threadIdx.x >> 5); r < r1; r += nw)
    for (int q = q0 + lane; q < q1; q += 32) f(r, q);
}

// acc[i] = sum_t g[t] src[(i + t) * stride], t < NT taps (NT = 0: nt at
// run time), for the R outputs of one strip: each input is read once and
// meets every tap of the strip that needs it.
template <int NT, int R>
__device__ __forceinline__ void tv_band(const float* src, int stride,
                                        const float* g, int nt,
                                        float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  if constexpr (NT > 0) {
#pragma unroll
    for (int u = 0; u < R + NT - 1; ++u) {
      const float v = src[u * stride];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int t = u - i;
        if (t >= 0 && t < NT) acc[i] = fmaf(g[t], v, acc[i]);
      }
    }
  } else {
    for (int u = 0; u < R + nt - 1; ++u) {
      const float v = src[u * stride];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int t = u - i;
        if (t >= 0 && t < nt) acc[i] = fmaf(g[t], v, acc[i]);
      }
    }
  }
}

// Row pitch of the shared arrays for a window nc wide: odd, so a warp
// down 32 rows of one column hits 32 banks.
__host__ __device__ __forceinline__ int tv_pitch(int nc) { return nc | 1; }

// Shared-memory floats of one block for a window of nr rows: five window
// arrays, then the rows a partial strip may read past the last of them.
__host__ __device__ __forceinline__ int tv_smem_floats(int nr, int nc) {
  const int p = tv_pitch(nc);
  return 5 * nr * p + (TV_R - 1) * p + TV_R;
}

// K levels of one TR x TC tile.  EDGE: the window may cross the image edge
// (four-stage path); else no boundary rule can apply inside it (normal
// form).  LK: the tap count of both axes when fixed at compile time, 0 for
// a runtime count.
template <typename TX, typename TZ, bool EDGE, int LK>
__device__ __forceinline__ void tv_levels(
    const TX* __restrict__ x, const TZ* __restrict__ z,
    const float* __restrict__ b, TX* __restrict__ xo, TZ* __restrict__ zo,
    const TVArgs& a, const int K) {
  extern __shared__ float smem[];
  const int H = a.H, W = a.W, TR = a.TR, TC = a.TC;
  const long HW = (long)H * W;
  const int L0 = LK ? LK : a.L0, L1 = LK ? LK : a.L1;
  const int c0 = a.c0, c1 = a.c1;
  const int r0 = blockIdx.y * TR, q0 = blockIdx.x * TC;
  // window: global (wr, wq) is local (0, 0); NR rows of pitch P (odd)
  const int wr = r0 - K * a.ap0, wq = q0 - K * a.ap1;
  const int NR = TR + 2 * K * a.ap0 + 1, NC = TC + 2 * K * a.ap1 + 1;
  const int P = tv_pitch(NC);
  float* X = smem;           // x state of the current level
  float* Z0 = X + NR * P;    // z state, component 0 (rows)
  float* Z1 = Z0 + NR * P;   // z state, component 1 (cols)
  float* S = Z1 + NR * P;    // tap-pass scratch, then the next level's x
  float* Y = S + NR * P;     // K x (edge blocks), then x+
#ifdef TV_PHASE_CLOCKS
  // thread 0's clock between the block's barriers, summed over blocks:
  // 0 window load, 1 tap stages before x+, 2 x+, 3 z+, 4 tile store
  long long tv_t = clock64();
#define TV_MARK(ph)                                                     \
  do {                                                                  \
    if (threadIdx.x == 0) {                                             \
      const long long t1 = clock64();                                   \
      atomicAdd(&tv_clocks[(EDGE ? 8 : 0) + (ph)],                      \
                (unsigned long long)(t1 - tv_t));                       \
      tv_t = t1;                                                        \
    }                                                                   \
  } while (0)
#else
#define TV_MARK(ph) \
  do {              \
  } while (0)
#endif
#define AT(A, r, q) A[((r) - wr) * P + ((q) - wq)]

  // load the window (clipped to the image)
  tv_rows(max(0, wr), min(H, wr + NR), max(0, wq), min(W, wq + NC),
          [&](int r, int q) {
            const long g = (long)r * W + q;
            tv_fill(&AT(X, r, q), x + g);
            tv_fill(&AT(Z0, r, q), z + g);
            tv_fill(&AT(Z1, r, q), z + HW + g);
          });
  // interior blocks: b on level j's x+ region into Y, where x+ will
  // overwrite it in place (level 1's with the window, later levels' while
  // pass 1 runs)
  auto fill_b = [&](int j) {
    const int e0 = (K - j) * a.ap0, e1 = (K - j) * a.ap1;
    tv_rows(r0 - e0, r0 + TR + e0 + 1, q0 - e1, q0 + TC + e1 + 1,
            [&](int p, int q) {
              tv_fill(&AT(Y, p, q), b + (long)p * W + q);
            });
  };
  if constexpr (!EDGE) fill_b(1);
  tv_fill_wait();
  __syncthreads();
  TV_MARK(0);

  for (int j = 1; j <= K; ++j) {
    const int e0 = (K - j) * a.ap0, e1 = (K - j) * a.ap1;
    const bool last = j == K;
    // x+ region (one extra row/col for the forward difference of v),
    // z+ region
    const int xr0 = max(0, r0 - e0), xr1 = min(H, r0 + TR + e0 + 1);
    const int xq0 = max(0, q0 - e1), xq1 = min(W, q0 + TC + e1 + 1);
    const int zr1 = min(H, r0 + TR + e0), zq1 = min(W, q0 + TC + e1);

    if constexpr (!EDGE) {
      // every index below lies inside the image: K^T K in normal form
      const int m0 = L0 - 1, m1 = L1 - 1;
      constexpr int NT = LK ? 2 * LK - 1 : 0;
      const int nh = xr1 - xr0;
      if (j > 1) fill_b(j);
      // pass 1: S = g0 band down the rows of X on [xr) x [xq0-m1, xq1+m1),
      // strips of TV_R rows, a warp across columns
      {
        const int sq0 = xq0 - m1, nw = xq1 - xq0 + 2 * m1;
        const int n = ((nh + TV_R - 1) / TV_R) * nw;
        for (int s = threadIdx.x; s < n; s += blockDim.x) {
          const int q = sq0 + s % nw, r = xr0 + (s / nw) * TV_R;
          float acc[TV_R];
          tv_band<NT>(&AT(X, r - m0, q), P, a.g0, 2 * L0 - 1, acc);
#pragma unroll
          for (int i = 0; i < TV_R; ++i)
            if (r + i < xr1) AT(S, r + i, q) = acc[i];
        }
      }
      tv_fill_wait();
      __syncthreads();
      TV_MARK(1);
      // pass 2: ktk = g1 band along the columns of S, then x+ into Y;
      // strips of TV_RC columns, a warp down rows
      {
        const int n = nh * ((xq1 - xq0 + TV_RC - 1) / TV_RC);
        for (int s = threadIdx.x; s < n; s += blockDim.x) {
          const int p = xr0 + s % nh, q = xq0 + (s / nh) * TV_RC;
          float acc[TV_RC];
          tv_band<NT>(&AT(S, p, q - m1), 1, a.g1, 2 * L1 - 1, acc);
          const float* xs = &AT(X, p, q);
          const float* z0s = &AT(Z0, p, q);
          const float* z0u = &AT(Z0, p - 1, q);
          const float* z1s = &AT(Z1, p, q);
          float* ys = &AT(Y, p, q);     // b in, x+ out
          float z1l = z1s[-1];
#pragma unroll
          for (int i = 0; i < TV_RC; ++i) {
            if (q + i < xq1) {
              const float z1c = z1s[i];
              const float gf = a.cst * acc[i] + ys[i];
              // D^T z away from the edges: d[i] = g[i-1] - g[i]
              const float dt = (z0u[i] - z0s[i]) + (z1l - z1c);
              ys[i] = xs[i] - a.tau * (gf + dt);
              z1l = z1c;
            }
          }
        }
      }
      __syncthreads();
      TV_MARK(2);
    } else {
      // K x region, row-stage column range
      const int yr0 = max(0, xr0 - a.h0), yr1 = min(H, xr1 + a.h0);
      const int yq0 = max(0, xq0 - a.h1), yq1 = min(W, xq1 + a.h1);
      const int sq0 = max(0, yq0 - a.h1), sq1 = min(W, yq1 + a.h1);
      // A: S = K's row stage (pad + valid corr along rows) on [yr) x [sq)
      // (each stage takes the rule-free loop at indices in [h, n - h),
      // where no reflection or fold-back reaches)
      tv_region(yr0, yr1, sq0, sq1, [&](int r, int q) {
        float acc = 0.f;
        if (r >= a.h0 && r < H - a.h0) {
          const float* src = &AT(X, r - c0, q);
#pragma unroll
          for (int t = 0; t < L0; ++t) acc += a.k0[t] * src[t * P];
        } else {
          for (int t = 0; t < L0; ++t) {
            const int s = tv_src(r + t - c0, H, a.sym_k);
            if (s >= 0) acc += a.k0[t] * AT(X, s, q);
          }
        }
        AT(S, r, q) = acc;
      });
      __syncthreads();
      TV_MARK(1);
      // B: Y = K x (column stage) on [yr) x [yq)
      tv_region(yr0, yr1, yq0, yq1, [&](int r, int q) {
        float acc = 0.f;
        if (q >= a.h1 && q < W - a.h1) {
          const float* src = &AT(S, r, q - c1);
#pragma unroll
          for (int t = 0; t < L1; ++t) acc += a.k1[t] * src[t];
        } else {
          for (int t = 0; t < L1; ++t) {
            const int s = tv_src(q + t - c1, W, a.sym_k);
            if (s >= 0) acc += a.k1[t] * AT(S, r, s);
          }
        }
        AT(Y, r, q) = acc;
      });
      __syncthreads();
      TV_MARK(1);
      // C: S = K^T's column stage of Y on [yr) x [xq): full correlation
      // with the flipped taps plus the symmetric fold-back of both ghost
      // regions
      tv_region(yr0, yr1, xq0, xq1, [&](int r, int q) {
        float acc = 0.f;
        if (q >= a.h1 && q < W - a.h1) {
          const float* src = &AT(Y, r, q + c1);
#pragma unroll
          for (int t = 0; t < L1; ++t) acc += a.k1[t] * src[-t];
        } else {
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
        }
        AT(S, r, q) = acc;
      });
      __syncthreads();
      TV_MARK(1);
      // D: x+ on [xr) x [xq), into Y
      tv_region(xr0, xr1, xq0, xq1, [&](int p, int q) {
        float ktk = 0.f;
        if (p >= a.h0 && p < H - a.h0) {
          const float* src = &AT(S, p + c0, q);
#pragma unroll
          for (int t = 0; t < L0; ++t) ktk += a.k0[t] * src[-t * P];
        } else {
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
        }
        const float gf = a.cst * ktk + b[(long)p * W + q];
        // D^T z: d[0] = -g[0], d[i] = g[i-1] - g[i]; symmetric adds g[n-1]
        const float z0c = AT(Z0, p, q), z1c = AT(Z1, p, q);
        float dt0 = (p > 0 ? AT(Z0, p - 1, q) : 0.f) - z0c;
        if (a.sym_d && p == H - 1) dt0 += z0c;
        float dt1 = (q > 0 ? AT(Z1, p, q - 1) : 0.f) - z1c;
        if (a.sym_d && q == W - 1) dt1 += z1c;
        AT(Y, p, q) = AT(X, p, q) - a.tau * (gf + dt0 + dt1);
      });
      __syncthreads();
      TV_MARK(2);
    }

    // E: z+ on [xr0, zr1) x [xq0, zq1), in place; the next level's x on
    // [xr) x [xq) into S where it is not x+ itself
    const bool x_is_xp =
        a.rho == 1.f && (last || std::is_same<TX, float>::value);
    // strips of TV_RC columns, a warp down rows; a strip's x and x+ (and
    // the row below) come into registers once
    {
      const int nh = xr1 - xr0;
      const int n = nh * ((xq1 - xq0 + TV_RC - 1) / TV_RC);
      for (int s = threadIdx.x; s < n; s += blockDim.x) {
        const int p = xr0 + s % nh, q = xq0 + (s / nh) * TV_RC;
        const float* xs = &AT(X, p, q);
        const float* ys = &AT(Y, p, q);
        float xv[TV_RC + 1], yv[TV_RC + 1], xd[TV_RC], yd[TV_RC];
#pragma unroll
        for (int i = 0; i <= TV_RC; ++i) {
          xv[i] = xs[i];
          yv[i] = ys[i];
        }
#pragma unroll
        for (int i = 0; i < TV_RC; ++i) {
          xd[i] = xs[i + P];
          yd[i] = ys[i + P];
        }
        float* z0s = &AT(Z0, p, q);
        float* z1s = &AT(Z1, p, q);
        float* ss = &AT(S, p, q);
#pragma unroll
        for (int i = 0; i < TV_RC; ++i) {
          const int qi = q + i;
          if (qi >= xq1) continue;
          const float xc = xv[i], xp = yv[i];
          if (p < zr1 && qi < zq1) {
            const float v = 2.f * xp - xc;
            float u0, u1;
            if (EDGE && p == H - 1) u0 = a.sym_d ? 0.f : -v;
            else u0 = 2.f * yd[i] - xd[i] - v;
            if (EDGE && qi == W - 1) u1 = a.sym_d ? 0.f : -v;
            else u1 = 2.f * yv[i + 1] - xv[i + 1] - v;
            const float z0c = z0s[i], z1c = z1s[i];
            const float t0 = z0c + a.sigma * u0, t1 = z1c + a.sigma * u1;
            const float fac = fminf(
                a.lam * rsqrtf(fmaxf(t0 * t0 + t1 * t1, FLT_MIN)), 1.f);
            float n0 = t0 * fac, n1 = t1 * fac;
            if (a.rho != 1.f) {
              n0 = z0c + a.rho * (n0 - z0c);
              n1 = z1c + a.rho * (n1 - z1c);
            }
            if (!last) {
              n0 = tv_round(n0, z);
              n1 = tv_round(n1, z);
            }
            z0s[i] = n0;
            z1s[i] = n1;
          }
          if (!x_is_xp) {
            float xn = a.rho != 1.f ? xc + a.rho * (xp - xc) : xp;
            if (!last) xn = tv_round(xn, x);
            ss[i] = xn;
          }
        }
      }
    }
    __syncthreads();
    TV_MARK(3);
    float* t = X;
    if (x_is_xp) {
      X = Y;
      Y = t;
    } else {
      X = S;
      S = t;
    }
  }

  // store the tile; the storage dtype rounds once here
  tv_rows(r0, min(H, r0 + TR), q0, min(W, q0 + TC), [&](int r, int q) {
    const long g = (long)r * W + q;
    tv_st(xo, g, AT(X, r, q));
    tv_st(zo, g, AT(Z0, r, q));
    tv_st(zo, HW + g, AT(Z1, r, q));
  });
  TV_MARK(4);
#ifdef TV_PHASE_CLOCKS
  if (threadIdx.x == 0) atomicAdd(&tv_clocks[(EDGE ? 8 : 0) + 7], 1ull);
#endif
#undef TV_MARK
#undef AT
}

// Whether this block's K-level window lies inside the image
// (ops/fused_tv.py interior_blocks mirrors this rule).
__device__ __forceinline__ bool tv_interior(const TVArgs& a, int K) {
  const int wr = blockIdx.y * a.TR - K * a.ap0;
  const int wq = blockIdx.x * a.TC - K * a.ap1;
  return wr >= 0 && wq >= 0 && wr + a.TR + 2 * K * a.ap0 + 1 <= a.H &&
         wq + a.TC + 2 * K * a.ap1 + 1 <= a.W;
}

template <typename TX, typename TZ, int LK>
__global__ void __launch_bounds__(TV_THREADS, 1024 / TV_THREADS)
tv_step_kernel(const TX* __restrict__ x, const TZ* __restrict__ z,
               const float* __restrict__ b, TX* __restrict__ xo,
               TZ* __restrict__ zo, const __grid_constant__ TVArgs a) {
  if (tv_interior(a, 1))
    tv_levels<TX, TZ, false, LK>(x, z, b, xo, zo, a, 1);
  else
    tv_levels<TX, TZ, true, LK>(x, z, b, xo, zo, a, 1);
}

template <typename TX, typename TZ, int LK>
__global__ void __launch_bounds__(TV_THREADS_K, 1024 / TV_THREADS_K)
tv_stepk_kernel(const TX* __restrict__ x, const TZ* __restrict__ z,
                const float* __restrict__ b, TX* __restrict__ xo,
                TZ* __restrict__ zo, const __grid_constant__ TVArgs a,
                int n_steps) {
  if (tv_interior(a, n_steps))
    tv_levels<TX, TZ, false, LK>(x, z, b, xo, zo, a, n_steps);
  else
    tv_levels<TX, TZ, true, LK>(x, z, b, xo, zo, a, n_steps);
}

static void tv_tile(int K, int* tr, int* tc) {
  static const int tiles[4][2] = {{TV_TR_1, TV_TC_1}, {TV_TR_2, TV_TC_2},
                                  {TV_TR_3, TV_TC_3}, {TV_TR_4, TV_TC_4}};
  const int i = (K < 4 ? K : 4) - 1;
  *tr = tiles[i][0];
  *tc = tiles[i][1];
}

template <typename TX, typename TZ, int LK>
static int tv_launch(const void* x, const void* z, const void* b, void* xo,
                     void* zo, const TVArgs& a, int K, cudaStream_t stream) {
  const size_t smem =
      (size_t)tv_smem_floats(a.TR + 2 * K * a.ap0 + 1,
                             a.TC + 2 * K * a.ap1 + 1) * sizeof(float);
  const dim3 grid((a.W + a.TC - 1) / a.TC, (a.H + a.TR - 1) / a.TR);
  cudaError_t err;
  if (K == 1) {
    err = cudaFuncSetAttribute(tv_step_kernel<TX, TZ, LK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    tv_step_kernel<TX, TZ, LK><<<grid, TV_THREADS, smem, stream>>>(
        (const TX*)x, (const TZ*)z, (const float*)b, (TX*)xo, (TZ*)zo, a);
  } else {
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

// g[d + L - 1] = sum_t k[t] k[t + d] (numpy correlate(k, k, "full")), in
// double, rounded once.
static void tv_normal_taps(const float* k, int L, float* g) {
  for (int d = 1 - L; d < L; ++d) {
    double acc = 0.0;
    for (int t = 0; t < L; ++t)
      if (t + d >= 0 && t + d < L) acc += (double)k[t] * (double)k[t + d];
    g[d + L - 1] = (float)acc;
  }
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
  for (int t = 0; t < TV_MAXG; ++t) a.g0[t] = a.g1[t] = 0.f;
  tv_normal_taps(k0, L0, a.g0);
  tv_normal_taps(k1, L1, a.g1);
  a.L0 = L0; a.L1 = L1; a.c0 = c0; a.c1 = c1;
  a.h0 = c0 > L0 - 1 - c0 ? c0 : L0 - 1 - c0;
  a.h1 = c1 > L1 - 1 - c1 ? c1 : L1 - 1 - c1;
  a.ap0 = a.h0 > 0 ? 2 * a.h0 : 1;
  a.ap1 = a.h1 > 0 ? 2 * a.h1 : 1;
  a.sym_k = sym_k; a.sym_d = sym_d;
  a.cst = cst; a.lam = lam; a.tau = tau; a.sigma = sigma; a.rho = rho;
  a.H = H; a.W = W;
  tv_tile(K, &a.TR, &a.TC);
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

#ifdef TV_PHASE_CLOCKS
// Copies the phase clocks into out[16] and zeroes them.
int tv_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, tv_clocks, sizeof(tv_clocks));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[16] = {0};
  return (int)cudaMemcpyToSymbol(tv_clocks, zero, sizeof(tv_clocks));
}
#endif

const char* tv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
