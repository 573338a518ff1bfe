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
// correlation at -1-s and 2n-1-s.  Only outputs within h of an edge do.
// Pad widths never exceed the axis length, so one reflection or fold
// suffices.
//
// Bound: one read and one write of each pixel.  At 2160x3840 f32 that is
// 66.4 MB, 19.8 us at 3.35 TB/s; the 2(L0+L1) flops per pixel (36 for 9+9
// taps) take 4.5 us at 67 TFLOP/s, so the kernel is bound by bytes, not
// operations.  (A plain copy of the frame, 66.4 MB moved, takes 25 us on
// the H100: PERF.md.)
//
// Design (row streaming): the rows are cut into strips of `sr` rows and the
// columns into bands of ST_BW = 32 ST_CPT; one warp owns one band of one
// strip and walks down it.  Input rows (the band and a halo of H1 columns a
// side, h1 rounded up to 16 bytes) stream through a ring of ST_NBUF row
// buffers in the warp's shared memory, loaded ST_NBUF - 1 rows ahead by
// cp.async (16 bytes a copy where the rows are 16-byte aligned), so loads
// overlap the arithmetic.  For each input row a lane computes the
// horizontal sums of its ST_CPT adjacent columns from the shared row, with
// the taps sliding in registers (ST_CPT + L1 - 1 values read, in 16-byte
// pieces), and keeps the last L0 sums of its columns in a register ring
// unrolled by L0; once L0 rows are in, it writes one output row,
// sum_t k0[t] ring[t], in 16-byte stores.  Taking the horizontal pass
// first only reorders the sums: the boundary maps act per axis.  The taps
// stay in the kernel's parameters, so the FMAs take them as constants.
// The warps of a block share nothing, so no block barrier runs after the
// taps are loaded.  Against the four limits of the window design it
// replaces (one 32x64 tile a block):
//  * three serial phases split by barriers: the next rows' loads are in
//    flight while the warp computes the current one, and an SM holds 16
//    warps (2 blocks of 8; ~90 registers a thread);
//  * ~21 shared accesses an output: now the row's copy in and the
//    ST_CPT + L1 - 1 window values a lane, in 16-byte reads, with no
//    shared intermediate: ~4 accesses an output at 9+9 taps;
//  * the halo read twice (1.41x the tile's bytes): a 32-row strip reads
//    L0 - 1 more rows and a 128-column band 2 H1 more columns, 1.33x at
//    9+9 taps, and the neighbouring strip's rows often come from L2;
//  * fold loops with runtime bounds on 6% of the blocks: the fold touches
//    only the frame of outputs within h of an edge, which the streaming
//    warps skip and 256 small edge blocks of the same launch (at 4K)
//    compute with the window routine (st_edge_tile); the apply's
//    reflection is a map of the loaded row and column indices and costs
//    nothing per tap.  Rows and bands that touch the image's edge, or are
//    not 16-byte aligned, load through one out-of-line routine, which
//    keeps the unrolled body small (inlined, it ran slower on the H100).
// At 2160x3840 the launch has 30 bands x 68 strips = 2040 warps in 255
// blocks, one wave at 2 blocks an SM.  Nine taps on both axes take the
// unrolled path (ST_FAST_L); other tap counts take the same streaming with
// runtime tap loops, columns laid across the warp (lane + 32k) and the
// ring of horizontal sums in shared memory.
//
// The strip height is ST_SR, halved (to ST_SR_MIN at least) while a launch
// would have fewer than ST_FILL warps, and the warps a block ST_WARPS,
// halved (to 2 at least) while it would have fewer than ST_BLOCKS blocks
// or overflow shared memory, so small images still spread over the SMs
// (256x256: 4-row strips, 64 blocks of 2 warps).  ops/stencil.py
// (launch_plan) mirrors the geometry.
//
// Per-member taps (stencil_launch_members): N tap sets with one centre,
// tap counts and mode, in device memory (N x L0 and N x L1, in the
// storage type).  Image b of the launch takes member b % N's taps, and
// reads input image b / x_rep (x_rep = N: every member correlates the same
// input, a stack's apply; x_rep = 1: image b's own, a block-diagonal
// operator).  A block loads its member's taps into shared memory, and the
// unrolled path copies them into registers, so the arithmetic and its
// order are those of the single-tap-set launch: the same taps give the
// same bits.  It is the counterpart of the JAX package's jax.vmap over a
// family of Stencils' taps (pyxu_tpu/operator/blocks.py), whose
// correlations run as one batched XLA op; it replaces no Pallas call of
// its own (separable_correlate2d, above, takes one tap set).  Bound: the
// same bytes as B single launches, the taps' N (L0 + L1) values besides.
//
// Reads never leave the image plane: rows and columns map through the
// boundary into [0, n), and halo columns beyond h of the image are never
// read.  Test builds define ST_COUNT_STRAY_READS: a read whose address
// falls outside the image's plane is then counted and loaded as zero
// instead, and stencil_stray_reads() returns the count.

#include <cuda_runtime.h>
#include <stdint.h>

#define ST_MAXL 32
// tap count of the unrolled path: for the workloads' 9+9-tap blur
#define ST_FAST_L 9
// streaming geometry, chosen on the H100 (chip_smoke.py's [sweep] lines,
// PERF.md section 6); ops/stencil.py mirrors it in _GEOM
#ifndef ST_CPT
#define ST_CPT 4            // adjacent output columns a lane
#endif
#ifndef ST_WARPS
#define ST_WARPS 8          // warps a block, at most
#endif
#ifndef ST_NBUF
#define ST_NBUF 4           // input rows in a warp's ring (power of 2)
#endif
#ifndef ST_SR
#define ST_SR 32            // rows a strip, at most
#endif
#ifndef ST_FILL
#define ST_FILL 1024        // warps a launch should reach
#endif
#define ST_SR_MIN 4
#define ST_BLOCKS 132       // streaming blocks a launch should reach
#define ST_BW (32 * ST_CPT)
// edge tile (rows x cols) of the fold; it must hold the halo
// (ST_TR, ST_TC >= ST_MAXL - 1)
#define ST_TR 32
#define ST_TC 64
#define ST_SMEM_MAX 232448  // dynamic shared memory a block may opt in to

static_assert((ST_NBUF & (ST_NBUF - 1)) == 0 && ST_NBUF >= 2,
              "ST_NBUF: a power of 2");
static_assert(ST_WARPS >= 2 && (ST_WARPS & (ST_WARPS - 1)) == 0,
              "ST_WARPS: a power of 2, at least 2");

#ifdef ST_COUNT_STRAY_READS
__device__ unsigned long long st_stray_reads;
#endif

struct StArgs {
  double k0[ST_MAXL];
  double k1[ST_MAXL];
  float k0f[ST_MAXL];  // the taps rounded to float, for float storage
  float k1f[ST_MAXL];
  int L0, L1, c0, c1;  // tap counts and centres (rows, cols)
  int h0, h1;          // halo per side (rows, cols)
  int H, W;
  int reflect;         // load outside the image through the symmetric map
  int fold;            // add the symmetric fold-back's ghost terms
  const void* mk0;     // per-member taps (N x L0, N x L1), or unused
  const void* mk1;
  int members;         // N: image b takes member b % N's taps
  int x_rep;           // image b reads input image b / x_rep
};

// launch geometry, computed on the host (st_plan)
struct StGeom {
  int bands, strips, sr;  // bands of ST_BW columns, strips of sr rows
  int warps;              // warps a block
  int n_stream;           // streaming blocks
  int n_edge;             // edge blocks (the fold's frame)
  int H1;                 // column halo of a ring row, rounded up to 16 B
  int rw;                 // elements of a ring row
  int warp_elems;         // shared elements of one warp
  int fa, fb, fa1, fb1;   // streaming warps store rows [fa, fb) x [fa1, fb1)
  int vec;                // rows 16-byte aligned: 16-byte copies and stores
};

__host__ __device__ __forceinline__ int st_cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Tap t of axis 0 or 1 in the storage type, read from the kernel's
// parameters: inside an unrolled loop an FMA takes it as a constant operand
// and spends no register on it.
template <typename T>
__device__ __forceinline__ T st_tap(const StArgs& a, int axis, int t) {
  if constexpr (sizeof(T) == 4)
    return axis ? a.k1f[t] : a.k0f[t];
  else
    return axis ? a.k1[t] : a.k0[t];
}

__device__ __forceinline__ int st_reflect(int q, int n) {
  return q < 0 ? -1 - q : (q >= n ? 2 * n - 1 - q : q);
}

// Rectangle k (0 top, 1 bottom, 2 left, 3 right) of the fold's frame:
// rows [r0, r1) x cols [q0, q1); returns its count of ST_TR x ST_TC edge
// tiles.
__host__ __device__ inline int st_rect(int k, const StArgs& a,
                                       const StGeom& g, int* r0, int* r1,
                                       int* q0, int* q1) {
  *r0 = k == 0 ? 0 : (k == 1 ? g.fb : g.fa);
  *r1 = k == 0 ? g.fa : (k == 1 ? a.H : g.fb);
  *q0 = k == 3 ? g.fb1 : 0;
  *q1 = k == 2 ? g.fa1 : a.W;
  if (*r1 <= *r0 || *q1 <= *q0) return 0;
  return st_cdiv(*r1 - *r0, ST_TR) * st_cdiv(*q1 - *q0, ST_TC);
}

// Whether the n elements at p leave the image plane at x (of `plane`
// elements); a test build (ST_COUNT_STRAY_READS) counts them and loads
// zeros instead.
template <typename T>
__device__ __forceinline__ bool st_stray(const T* x, const T* p, int n,
                                         long plane) {
#ifdef ST_COUNT_STRAY_READS
  const long o = (long)(p - x);
  if (o >= 0 && o + n <= plane) return false;
  atomicAdd(&st_stray_reads, 1ull);
  return true;
#else
  return false;
#endif
}

// ------------------------------------------------------------ cp.async --

__device__ __forceinline__ void st_cp16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

template <typename T>
__device__ __forceinline__ void st_cp1(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ void st_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void st_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// RV consecutive values at p (RV * sizeof(T) <= 16 bytes, aligned to that)
template <typename T, int RV>
__device__ __forceinline__ void st_get(const T* p, T* w) {
  if constexpr (RV == 4 && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (RV == 2 && sizeof(T) == 8) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (RV == 2 && sizeof(T) == 4) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
#pragma unroll
    for (int e = 0; e < RV; ++e) w[e] = p[e];
  }
}

template <typename T, int RV>
__device__ __forceinline__ void st_put(T* p, const T* w) {
  if constexpr (RV == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(w[0], w[1], w[2], w[3]);
  } else if constexpr (RV == 2 && sizeof(T) == 8) {
    *reinterpret_cast<double2*>(p) = make_double2(w[0], w[1]);
  } else if constexpr (RV == 2 && sizeof(T) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(w[0], w[1]);
  } else {
#pragma unroll
    for (int e = 0; e < RV; ++e) p[e] = w[e];
  }
}

// ---------------------------------------------------------- ring loads --

// Ring row <- image row r (mapped into the image, or outside it: zeros),
// columns [qs, qs + n) through the column map, for the rows and bands
// that touch the image's edge or are not 16-byte aligned; columns more
// than h1 outside the image are never used and load as zero.  Kept out of
// line, with scalar arguments, so the unrolled streaming body stays small.
template <typename T>
__device__ __noinline__ void st_load_row_edge(T* dst, const T* __restrict__ x,
                                              int r, int qs, int n, int H,
                                              int W, int h1, int reflect,
                                              int lane) {
  const long plane = (long)H * W;
  if (r < 0 || r >= H) {
    for (int v = lane; v < n; v += 32) dst[v] = T(0);
    return;
  }
  const T* row = x + (long)r * W;
  for (int v = lane; v < n; v += 32) {
    int q = qs + v;
    if (reflect && q >= -h1 && q < W + h1) q = st_reflect(q, W);
    if (q >= 0 && q < W && !st_stray(x, row + q, 1, plane))
      st_cp1(dst + v, row + q);
    else
      dst[v] = T(0);
  }
}

// Ring row <- image row r (through the row map), columns [q0 - H1,
// q0 + ST_BW + H1); one warp, lane `lane`.  The last vector of a ring
// row is never used and not loaded.
template <typename T>
__device__ __forceinline__ void st_load_row(T* dst, const T* __restrict__ x,
                                            int r, int q0, const StArgs& a,
                                            const StGeom& g, int lane) {
  constexpr int V = 16 / sizeof(T);
  if (a.reflect) r = st_reflect(r, a.H);
  const int qs = q0 - g.H1, n = ST_BW + 2 * g.H1;
  if (g.vec && r >= 0 && r < a.H && qs >= 0 && qs + n <= a.W) {
    const T* row = x + (long)r * a.W + qs;
    for (int c = lane; c < n / V; c += 32) {
      if (!st_stray(x, row + c * V, V, (long)a.H * a.W)) {
        st_cp16(dst + c * V, row + c * V);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) dst[c * V + e] = T(0);
      }
    }
  } else {
    st_load_row_edge(dst, x, r, qs, n, a.H, a.W, a.h1, a.reflect, lane);
  }
}

// ------------------------------------------------------ streaming warp --

// The rows of one warp's strip: loop row i (of n_in) is image row
// r0 + i; from loop row L0 - 1 on, each gives output row s0 + i - L0 + 1.
struct StStrip {
  int n_in, r0, s0;
};

__device__ __forceinline__ StStrip st_strip(const StArgs& a, const StGeom& g,
                                            int strip, int L0) {
  const int s0 = strip * g.sr, s_end = min(s0 + g.sr, a.H);
  return {s_end - s0 + L0 - 1, s0 - a.c0, s0};
}

// Start the load of loop row j into its ring slot, if the strip needs it;
// one commit group per call either way.
template <typename T>
__device__ __forceinline__ void st_prefetch(T* ring, const T* __restrict__ x,
                                            int j, const StStrip& sp, int q0,
                                            const StArgs& a, const StGeom& g,
                                            int lane) {
  if (j < sp.n_in)
    st_load_row(ring + (j & (ST_NBUF - 1)) * g.rw, x, sp.r0 + j, q0, a, g,
                lane);
  st_commit();
}

// The unrolled path: LK taps on both axes; SUB = (H1 - c1) mod RV.  PM:
// the taps of the block's member, from the shared k0s / k1s into
// registers; otherwise from the kernel's parameters.
template <typename T, int LK, int SUB, bool PM>
__device__ __forceinline__ void st_stream_fixed(
    const T* __restrict__ x, T* __restrict__ y, const StArgs& a,
    const StGeom& g, const T* k0s, const T* k1s, T* ring, int band,
    const StStrip& sp, int lane) {
  constexpr int V = 16 / sizeof(T);
  constexpr int RV = ST_CPT < V ? ST_CPT : V;   // vector of a lane's reads
  constexpr int NW = (SUB + ST_CPT - 1 + LK + RV - 1) / RV * RV;
  const int q0 = band * ST_BW;
  const int base = ST_CPT * lane + g.H1 - a.c1 - SUB;
  const int qo = q0 + ST_CPT * lane;
  T tk0[LK], tk1[LK];
  if constexpr (PM) {
#pragma unroll
    for (int t = 0; t < LK; ++t) {
      tk0[t] = k0s[t];
      tk1[t] = k1s[t];
    }
  }
  T ring_r[LK][ST_CPT];
#pragma unroll 1
  for (int j = 0; j < ST_NBUF - 1; ++j)
    st_prefetch(ring, x, j, sp, q0, a, g, lane);
  for (int i0 = 0; i0 < sp.n_in; i0 += LK) {
#pragma unroll
    for (int u = 0; u < LK; ++u) {
      const int i = i0 + u;
      if (i >= sp.n_in) break;
      st_wait<ST_NBUF - 2>();
      __syncwarp();
      st_prefetch(ring, x, i + ST_NBUF - 1, sp, q0, a, g, lane);
      const T* row = ring + (i & (ST_NBUF - 1)) * g.rw + base;
      T w[NW];
#pragma unroll
      for (int v = 0; v < NW; v += RV) st_get<T, RV>(row + v, w + v);
#pragma unroll
      for (int k = 0; k < ST_CPT; ++k) {
        T h = T(0);
#pragma unroll
        for (int b = 0; b < LK; ++b)
          h += (PM ? tk1[b] : st_tap<T>(a, 1, b)) * w[SUB + k + b];
        ring_r[u][k] = h;
      }
      if (i >= LK - 1) {
        const int s = sp.s0 + i - (LK - 1);
        if (s >= g.fa && s < g.fb && qo < a.W) {
          T out[ST_CPT];
#pragma unroll
          for (int k = 0; k < ST_CPT; ++k) {
            T acc = T(0);
            // tap t reads image row s - c0 + t: loop row i - LK + 1 + t
#pragma unroll
            for (int t = 0; t < LK; ++t)
              acc += (PM ? tk0[t] : st_tap<T>(a, 0, t)) *
                     ring_r[(u + 1 + t) % LK][k];
            out[k] = acc;
          }
          T* yrow = y + (long)s * a.W;
          if (g.vec && qo >= g.fa1 && qo + ST_CPT <= g.fb1) {
#pragma unroll
            for (int k = 0; k < ST_CPT; k += RV)
              st_put<T, RV>(yrow + qo + k, out + k);
          } else {
#pragma unroll
            for (int k = 0; k < ST_CPT; ++k) {
              const int q = qo + k;
              if (q >= g.fa1 && q < g.fb1) yrow[q] = out[k];
            }
          }
        }
      }
    }
  }
  st_wait<0>();
}

// Runtime tap counts: lane owns columns lane + 32 k; the last L0
// horizontal sums of its columns live in the warp's shared ring `hs`.
template <typename T>
__device__ __forceinline__ void st_stream_any(
    const T* __restrict__ x, T* __restrict__ y, const StArgs& a,
    const StGeom& g, const T* k0s, const T* k1s, T* ring, int band,
    const StStrip& sp, int lane) {
  const int L0 = a.L0, L1 = a.L1;
  const int q0 = band * ST_BW;
  const int off = g.H1 - a.c1;
  T* hs = ring + ST_NBUF * g.rw;     // L0 rows of ST_BW sums
#pragma unroll 1
  for (int j = 0; j < ST_NBUF - 1; ++j)
    st_prefetch(ring, x, j, sp, q0, a, g, lane);
  int slot = 0;                      // hs row of loop row i
  for (int i = 0; i < sp.n_in; ++i) {
    st_wait<ST_NBUF - 2>();
    __syncwarp();
    st_prefetch(ring, x, i + ST_NBUF - 1, sp, q0, a, g, lane);
    const T* row = ring + (i & (ST_NBUF - 1)) * g.rw + off;
#pragma unroll
    for (int k = 0; k < ST_CPT; ++k) {
      const int v = lane + 32 * k;
      T h = T(0);
      for (int b = 0; b < L1; ++b) h += k1s[b] * row[v + b];
      hs[slot * ST_BW + v] = h;
    }
    if (i >= L0 - 1) {
      const int s = sp.s0 + i - (L0 - 1);
      if (s >= g.fa && s < g.fb) {
        T* yrow = y + (long)s * a.W;
#pragma unroll
        for (int k = 0; k < ST_CPT; ++k) {
          const int v = lane + 32 * k, q = q0 + v;
          T acc = T(0);
          int sl = slot + 1 == L0 ? 0 : slot + 1;   // the oldest row: tap 0
          for (int t = 0; t < L0; ++t) {
            acc += k0s[t] * hs[sl * ST_BW + v];
            sl = sl + 1 == L0 ? 0 : sl + 1;
          }
          if (q < a.W && q >= g.fa1 && q < g.fb1) yrow[q] = acc;
        }
      }
    }
    slot = slot + 1 == L0 ? 0 : slot + 1;
  }
  st_wait<0>();
}

// ------------------------------------------------------ fold edge tile --

// Outputs [r0, r0 + rows) x [q0, q0 + cols) (at most ST_TR x ST_TC) with
// the fold's ghost terms: the window (the tile and a halo of h per side,
// zero outside the image) in S, the vertical pass into V, then the
// horizontal pass.  The fold needs every reflected index inside the
// window, which holds for any tile: a ghost index lies within h of the
// edge the tile's own outputs lie within h of.  LK: the tap count of both
// axes when fixed at compile time, 0 for a runtime count.
template <typename T, int LK>
__device__ __forceinline__ void st_edge_tile(const T* __restrict__ x,
                                             T* __restrict__ y,
                                             const StArgs& a, const T* k0,
                                             const T* k1, T* S, int r0,
                                             int q0, int rows, int cols) {
  const int H = a.H, W = a.W;
  const int L0 = LK ? LK : a.L0, L1 = LK ? LK : a.L1;
  const int c0 = a.c0, c1 = a.c1, h0 = a.h0, h1 = a.h1;
  // window: global (wr, wq) is local (0, 0); NR x NC used, row pitch P
  const int wr = r0 - h0, wq = q0 - h1;
  const int NR = rows + 2 * h0, NC = cols + 2 * h1, P = ST_TC + 2 * h1;
  const int nt = blockDim.x;
  T* V = S + (ST_TR + 2 * h0) * P;

  // the block's threads take the window's elements in turn, four loads
  // in flight a thread
#pragma unroll 4
  for (int i = threadIdx.x; i < NR * NC; i += nt) {
    const int u = i / NC, v = i - u * NC;
    const int g = wr + u, gq = wq + v;
    const T* p = x + (long)g * W + gq;
    const bool in = g >= 0 && g < H && gq >= 0 && gq < W &&
                    !st_stray(x, p, 1, (long)H * W);
    S[u * P + v] = in ? *p : T(0);
  }
  __syncthreads();

  // vertical pass over every used window column, for the tile's rows
  for (int e = threadIdx.x; e < rows * NC; e += nt) {
    const int i = e / NC, v = e - i * NC;
    const int s = r0 + i;
    const T* src = S + (i + h0 - c0) * P + v;
    T acc = T(0);
#pragma unroll
    for (int t = 0; t < L0; ++t) acc += k0[t] * src[t * P];
    for (int t = 0; t < L0; ++t) {
      const int lo = -1 - s + t - c0, hi = 2 * H - 1 - s + t - c0;
      if (lo >= 0) acc += k0[t] * S[(lo - wr) * P + v];
      if (hi < H) acc += k0[t] * S[(hi - wr) * P + v];
    }
    V[i * P + v] = acc;
  }
  __syncthreads();

  // horizontal pass; each output pixel is written once
  for (int e = threadIdx.x; e < rows * cols; e += nt) {
    const int i = e / cols, j = e - i * cols;
    const T* row = V + i * P;
    const int q = q0 + j;
    const T* src = row + j + h1 - c1;
    T acc = T(0);
#pragma unroll
    for (int t = 0; t < L1; ++t) acc += k1[t] * src[t];
    for (int t = 0; t < L1; ++t) {
      const int lo = -1 - q + t - c1, hi = 2 * W - 1 - q + t - c1;
      if (lo >= 0) acc += k1[t] * row[lo - wq];
      if (hi < W) acc += k1[t] * row[hi - wq];
    }
    y[(long)(r0 + i) * W + q] = acc;
  }
}

// ---------------------------------------------------------------- kernel --

// Blocks [0, n_stream) stream (one band and strip a warp); the others, in
// fold mode only, compute the frame's edge tiles.  blockIdx.y: the image.
// LK: ST_FAST_L for the unrolled path, 0 for runtime tap counts.  PM: the
// image's member's taps from device memory (a.mk0, a.mk1).
template <typename T, int LK, int SUB, bool PM>
__global__ void __launch_bounds__(32 * ST_WARPS)
st_kernel(const T* __restrict__ x, T* __restrict__ y, StArgs a, StGeom g) {
  extern __shared__ __align__(16) unsigned char st_smem[];
  __shared__ T k0[ST_MAXL], k1[ST_MAXL];
  const int t = threadIdx.x;
  if constexpr (PM) {
    const long m = blockIdx.y % a.members;
    if (t < ST_MAXL) {
      k0[t] = t < a.L0 ? static_cast<const T*>(a.mk0)[m * a.L0 + t] : T(0);
      k1[t] = t < a.L1 ? static_cast<const T*>(a.mk1)[m * a.L1 + t] : T(0);
    }
  } else if (t < ST_MAXL) {
    k0[t] = (T)a.k0[t];
    k1[t] = (T)a.k1[t];
  }
  __syncthreads();
  const long plane = (long)a.H * a.W;
  x += (PM ? blockIdx.y / a.x_rep : blockIdx.y) * plane;
  y += blockIdx.y * plane;
  T* S = reinterpret_cast<T*>(st_smem);
  const int blk = blockIdx.x;
  if (blk < g.n_stream) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int w = blk * g.warps + warp;
    if (w >= g.bands * g.strips) return;
    T* ring = S + warp * g.warp_elems;
    const StStrip sp = st_strip(a, g, w / g.bands, LK ? LK : a.L0);
    if constexpr (LK > 0) {
      st_stream_fixed<T, LK, SUB, PM>(x, y, a, g, k0, k1, ring, w % g.bands,
                                      sp, lane);
    } else {
      st_stream_any<T>(x, y, a, g, k0, k1, ring, w % g.bands, sp, lane);
    }
    return;
  }
  int e = blk - g.n_stream;
  for (int k = 0; k < 4; ++k) {
    int r0, r1, q0, q1;
    const int n = st_rect(k, a, g, &r0, &r1, &q0, &q1);
    if (e < n) {
      const int nc = st_cdiv(q1 - q0, ST_TC);
      const int tr = r0 + (e / nc) * ST_TR, tq = q0 + (e % nc) * ST_TC;
      st_edge_tile<T, LK>(x, y, a, k0, k1, S, tr, tq, min(ST_TR, r1 - tr),
                          min(ST_TC, q1 - tq));
      return;
    }
    e -= n;
  }
}

// ------------------------------------------------------------------ host --

static size_t st_edge_smem(const StArgs& a, size_t elem) {
  const size_t P = ST_TC + 2 * a.h1;
  return ((ST_TR + 2 * a.h0) * P + ST_TR * P) * elem;
}

// The launch geometry of one call; returns the dynamic shared memory a
// block asks for.
static size_t st_plan(const StArgs& a, int B, size_t elem, int aligned,
                      StGeom* g) {
  const int V = 16 / (int)elem;
  const bool fast = a.L0 == ST_FAST_L && a.L1 == ST_FAST_L;
  g->bands = st_cdiv(a.W, ST_BW);
  g->sr = ST_SR;
  while (g->sr > ST_SR_MIN &&
         (long)B * g->bands * st_cdiv(a.H, g->sr) < ST_FILL)
    g->sr /= 2;
  g->strips = st_cdiv(a.H, g->sr);
  g->H1 = st_cdiv(a.h1, V) * V;
  // the band, its halo, and a vector a lane's window may read past it
  g->rw = ST_BW + 2 * g->H1 + V;
  g->warp_elems = ST_NBUF * g->rw + (fast ? 0 : a.L0 * ST_BW);
  g->vec = aligned && a.W % V == 0;
  if (a.fold) {
    g->fa = a.h0 < a.H ? a.h0 : a.H;
    g->fb = a.H - a.h0 > g->fa ? a.H - a.h0 : g->fa;
    g->fa1 = a.h1 < a.W ? a.h1 : a.W;
    g->fb1 = a.W - a.h1 > g->fa1 ? a.W - a.h1 : g->fa1;
  } else {
    g->fa = 0; g->fb = a.H; g->fa1 = 0; g->fb1 = a.W;
  }
  g->n_edge = 0;
  if (a.fold) {
    int r0, r1, q0, q1;
    for (int k = 0; k < 4; ++k)
      g->n_edge += st_rect(k, a, *g, &r0, &r1, &q0, &q1);
  }
  const size_t edge = g->n_edge ? st_edge_smem(a, elem) : 0;
  // fewer warps a block while the ring overflows shared memory or the
  // launch has fewer blocks than ST_BLOCKS
  g->warps = ST_WARPS;
  size_t smem;
  for (;;) {
    smem = (size_t)g->warps * g->warp_elems * elem;
    if (edge > smem) smem = edge;
    g->n_stream = st_cdiv(g->bands * g->strips, g->warps);
    if (g->warps == 2 ||
        (smem <= ST_SMEM_MAX && (long)B * g->n_stream >= ST_BLOCKS))
      break;
    g->warps /= 2;
  }
  return smem;
}

template <typename T, int LK, int SUB, bool PM>
static int st_launch(const void* x, void* y, int B, const StArgs& a,
                     const StGeom& g, size_t smem, cudaStream_t stream) {
  static size_t opted = 48 * 1024;   // dynamic shared memory opted in to
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        st_kernel<T, LK, SUB, PM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const dim3 grid(g.n_stream + g.n_edge, B);
  st_kernel<T, LK, SUB, PM><<<grid, 32 * g.warps, smem, stream>>>(
      (const T*)x, (T*)y, a, g);
  return (int)cudaGetLastError();
}

template <typename T, bool PM>
static int st_launch_taps(const void* x, void* y, int B, const StArgs& a,
                          const StGeom& g, size_t smem, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  constexpr int RV = ST_CPT < V ? ST_CPT : V;
  if (!(a.L0 == ST_FAST_L && a.L1 == ST_FAST_L))
    return st_launch<T, 0, 0, PM>(x, y, B, a, g, smem, s);
  switch ((g.H1 - a.c1) % RV) {
    case 0: return st_launch<T, ST_FAST_L, 0, PM>(x, y, B, a, g, smem, s);
    case 1:
      return st_launch<T, ST_FAST_L, 1 % RV, PM>(x, y, B, a, g, smem, s);
    case 2:
      return st_launch<T, ST_FAST_L, 2 % RV, PM>(x, y, B, a, g, smem, s);
    default:
      return st_launch<T, ST_FAST_L, 3 % RV, PM>(x, y, B, a, g, smem, s);
  }
}

static int st_args(StArgs* a, int H, int W, const double* k0, int L0,
                   int c0, const double* k1, int L1, int c1, int reflect,
                   int fold) {
  if (L0 < 1 || L0 > ST_MAXL || L1 < 1 || L1 > ST_MAXL || c0 < 0 ||
      c0 >= L0 || c1 < 0 || c1 >= L1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < ST_MAXL; ++t) {
    a->k0[t] = k0 && t < L0 ? k0[t] : 0.0;
    a->k1[t] = k1 && t < L1 ? k1[t] : 0.0;
    a->k0f[t] = (float)a->k0[t];
    a->k1f[t] = (float)a->k1[t];
  }
  a->L0 = L0; a->L1 = L1; a->c0 = c0; a->c1 = c1;
  a->h0 = c0 > L0 - 1 - c0 ? c0 : L0 - 1 - c0;
  a->h1 = c1 > L1 - 1 - c1 ? c1 : L1 - 1 - c1;
  a->H = H; a->W = W;
  a->reflect = reflect; a->fold = fold;
  a->mk0 = a->mk1 = nullptr;
  a->members = a->x_rep = 1;
  // one reflection must reach back into the image
  if ((reflect || fold) && (a->h0 > H || a->h1 > W))
    return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" {

// y = one separable correlation of each of the B contiguous (H, W) images
// of x.  f64: 1 for double storage, 0 for float.  reflect / fold as in
// StArgs.  Returns cudaGetLastError() after the launch.
int stencil_launch(const void* x, void* y, int B, int H, int W, int f64,
                   const double* k0, int L0, int c0, const double* k1, int L1,
                   int c1, int reflect, int fold, void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  StArgs a;
  const int err = st_args(&a, H, W, k0, L0, c0, k1, L1, c1, reflect, fold);
  if (err) return err;
  const int aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  StGeom g;
  const size_t smem = st_plan(a, B, f64 ? 8 : 4, aligned, &g);
  if (smem > ST_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64) return st_launch_taps<double, false>(x, y, B, a, g, smem, s);
  return st_launch_taps<float, false>(x, y, B, a, g, smem, s);
}

// y = B correlations of (H, W) images: image b with member b % n_members's
// taps (k0: n_members x L0, k1: n_members x L1, device arrays in the
// storage type) of input image b / x_rep of x (x_rep: 1, or n_members
// when every member reads the same input).  B must be a multiple of
// n_members.  Returns cudaGetLastError() after the launch.
int stencil_launch_members(const void* x, void* y, int B, int H, int W,
                           int f64, const void* k0, int L0, int c0,
                           const void* k1, int L1, int c1, int n_members,
                           int x_rep, int reflect, int fold, void* stream) {
  if (B < 1 || B > 65535 || n_members < 1 || B % n_members != 0 ||
      (x_rep != 1 && x_rep != n_members) || !k0 || !k1)
    return (int)cudaErrorInvalidValue;
  StArgs a;
  const int err = st_args(&a, H, W, nullptr, L0, c0, nullptr, L1, c1,
                          reflect, fold);
  if (err) return err;
  a.mk0 = k0; a.mk1 = k1;
  a.members = n_members; a.x_rep = x_rep;
  const int aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  StGeom g;
  const size_t smem = st_plan(a, B, f64 ? 8 : 4, aligned, &g);
  if (smem > ST_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64) return st_launch_taps<double, true>(x, y, B, a, g, smem, s);
  return st_launch_taps<float, true>(x, y, B, a, g, smem, s);
}

// The geometry stencil_launch would use, into out[10]: bands, strips,
// strip rows, warps a block, streaming blocks, edge blocks, dynamic shared
// bytes, ring row elements, 16-byte path (for 16-byte aligned pointers),
// the unrolled path.  Returns 0, or cudaErrorInvalidValue.
int stencil_plan(int B, int H, int W, int f64, int L0, int c0, int L1,
                 int c1, int reflect, int fold, long long* out) {
  StArgs a;
  const int err = st_args(&a, H, W, nullptr, L0, c0, nullptr, L1, c1,
                          reflect, fold);
  if (err) return err;
  StGeom g;
  const size_t smem = st_plan(a, B, f64 ? 8 : 4, 1, &g);
  const long long v[10] = {g.bands, g.strips, g.sr, g.warps, g.n_stream,
                           g.n_edge, (long long)smem, g.rw, g.vec,
                           L0 == ST_FAST_L && L1 == ST_FAST_L};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

const char* stencil_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#ifdef ST_COUNT_STRAY_READS
// stray reads counted since the last call (then reset), or -1 when the
// device symbol cannot be read
long long stencil_stray_reads() {
  unsigned long long n = 0, zero = 0;
  if (cudaMemcpyFromSymbol(&n, st_stray_reads, sizeof n) != cudaSuccess ||
      cudaMemcpyToSymbol(st_stray_reads, &zero, sizeof zero) != cudaSuccess)
    return -1;
  return (long long)n;
}
#endif

}  // extern "C"
