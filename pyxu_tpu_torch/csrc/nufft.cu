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
// complex, stored as (re, im) pairs; the grid is row-major.  The plan (built
// on the device in float64, ops/nufft.py plan2 / plan3) sorts the points by
// the bin of their left tap (32x32 in 2-D; in 3-D ops/nufft.py bin3).
// Strengths are read, and results written, through the plan's permutation,
// so both take and return points in their original order.
//
// Bound (the chip_smoke.py kernel phases, M points, w taps): bytes = the
// points' plan data and values read once plus the grid written (spread) or
// read (interp) once; operations = M (w^d complex-by-real multiply-adds +
// d*w ES evaluations).  At 10^6 points, w = 7, a 2048^2 f32 grid the grid's
// 33.5 MB dominate the bytes (~13 us at 3.35 TB/s); at 2^21 points on a
// 256^3 grid the 134 MB grid (~40 us) and the 7.2e8 tap products (~40 us
// at 67 TFLOP/s) tie.
//
// Spread: owner computes, as the TPU's ragged_pencil_spread3 forms a strip
// of the grid from the points that reach it, without its one-hot matrices.
// The plan sorts the points within each bin by spread bin (4^3 cells in 3-D,
// 8^2 in 2-D) and cuts the grid into tasks (ops/nufft.py spread_tasks): a
// bin, or, where the points around it are many, a part of it (slabs of
// planes along axis 0, then strips of rows along axis 1).  One block per
// (task, batch element):
//   - it reads the spread bins whose points can tap its cells (a box of
//     them, at most NU_MAXSEG; per spread bin a start and a count), numbers
//     their points in one sequence by a block-wide prefix, keeps those that
//     reach its cells (a ballot and a prefix over the warps, so their order
//     is fixed) and stages them NU_CHUNK at a time in shared memory: per
//     point its strength (through the permutation) and per axis its w ES
//     weights added at the task's cells they land on (zero elsewhere; two
//     taps land on one cell where a grid side is under w);
//   - each thread owns a patch of cells in registers (RT along the last
//     axis by RA rows); each warp lists the staged points with a weight on
//     its planes and rows, and adds c W0[u] W1[v] Wlast[t] of each to its
//     patch, the weights read by 16-byte loads;
//   - each chunk sums into a partial that is then added to the cell's sum
//     (a float32 running sum of thousands of products in one cell, a radial
//     set's centre, would drift past 1e-5 of it);
//   - the block writes its cells once, zeros included, through shared
//     memory so that each warp stores whole rows.
// No atomics: every cell is summed by one thread in the plan's order, so two
// launches give the same bits, and the grid needs no zeroing.  What bounds it
// is instruction throughput, not bytes: a point's w^d taps reach about half
// the warps of a whole-bin task, whose patches hold several times the cells
// its taps fill, and a point within w - 1 cells of a task's edge is staged
// by each task it reaches (2.6 tasks a point on average at 16^3 and w = 7).
// A dense bin (a radial set's centre) is cut into parts, each walking the
// points of all of its neighbourhood, so that one bin does not serialise a
// block; the heaviest tasks launch first.  Times and their split: PERF.md.
//
// Interp: the cuFINUFFT subproblem method, redesigned for Hopper.  The
// plan splits bins of more than MAX_SUB points into subproblems.  What
// bounded the first design (PERF.md, the split of its time by the
// NU_TIME_INTERP_* builds below): in 3-D the taps (two 4-byte shared
// reads a tap, 32 lanes at 32 random cells, runtime-w loops) and the
// subgrid load (integer divisions a cell; then, per row, a copy
// instruction's fixed cost); in 2-D the taps and the results' scattered
// stores.  The design:
//   - the subgrid, the bin plus a w - 1 halo per axis (wrapping), comes
//     into shared memory row by row as bulk copies of the tensor memory
//     accelerator (cp.async.bulk, one a row, two where a row wraps), each
//     issued by one thread that walks its grid rows incrementally, and
//     completing on an mbarrier; rows that are not 16-byte aligned (a
//     float32 grid with an odd last side) copy by cp.async a cell;
//   - the taps are fixed at compile time (w = 2..16, a switch picks), each
//     one 16- or 8-byte shared read, the next point's data fetched while
//     this one's taps run;
//   - 3-D: a group of 16 lanes sums one point (NuTapShape): lanes along the
//     last axis (two cells a read in float32 up to w = 7), rows stacked,
//     the row pitch padded so that the rows one wavefront serves fall on
//     disjoint banks; each ES weight evaluated once in the group and
//     shuffled; the group's sum by shuffles in a fixed order.  Blocks of
//     512 threads, two an SM, so one block's copy runs beside the other's
//     taps;
//   - 2-D (49 taps at w = 7, fewer than a group's shuffles would cost): a
//     thread sums one point, with two accumulator pairs, in blocks of 128
//     threads, eight an SM.
// No atomics: two launches give the same bits.  What bounds it now: the
// taps' shared-memory wavefronts and issue slots (3-D: 28 wavefronts a
// point at w = 7, 49 of 64 lanes' reads used); times in PERF.md.  Tensor
// cores are left out: one point's taps share no operand with another's,
// and a dense product of the subgrid with per-point weights does about 6x
// the work.

#include <cuda_runtime.h>

#define NU_BIN 32        // 2-D bin side (grid cells); ops/nufft.py mirrors it
#define NU_MAXW 16       // most taps per axis
#define NU_THREADS 256   // ops/nufft.py THREADS
#define NU_WARPS (NU_THREADS / 32)
#define NU_CHUNK 128     // spread: points staged in shared memory at a time
#define NU_RMAX 16       // spread: most cells a thread owns in 3-D, and
#define NU_RMAX2 4       // in 2-D (ops/nufft.py MAX_RUN)

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

// ---------------------------------------------------------------- spread --

#define NU_MAXSEG 1024   // most spread bins one task reads (ops/nufft.py
                         // MAX_SEG)
// timing-only builds (wrong sums; chip_smoke.py NU_PHASES): NU_TIME_NO_ACC
// stages the points but adds none, NU_TIME_NO_STAGE keeps the reaching
// points and stages none
#ifdef NU_TIME_NO_STAGE
#define NU_TIME_NO_ACC
#endif

struct NuSpreadArgs {
  int n[3];       // grid sides
  int b[3];       // bin sides
  int ns[3];      // spread bins per axis
  int hwm[3];     // (w / 2) mod n[a]
  int w, hw, M;   // taps per axis, w / 2, points
  int rec;        // most staged weights of a point, 16-byte padded
  int cells;      // most cells of a task: NU_THREADS NU_RMAX(2)
  double beta;
};

template <typename T> struct NuVec2;
template <> struct NuVec2<float> { typedef float2 type; };
template <> struct NuVec2<double> { typedef double2 type; };

// shared memory of a spread block
template <typename T>
struct NuSpreadSmem {
  T* W;        // [NU_CHUNK][rec]: the staged points' placed weights
  T* C;        // [NU_CHUNK][2]: their strengths
  int4* list;  // [NU_CHUNK + NU_THREADS]: reaching points (j, rel0..2)
  int* seg;    // [NU_MAXSEG]: first sorted point of each spread bin read
  int* pre;    // [NU_MAXSEG + 1]: points read before each spread bin
  int* warp;   // [NU_WARPS]
  int* wlist;  // [NU_WARPS][NU_CHUNK]: each warp's staged points
};

template <typename T>
__device__ __forceinline__ NuSpreadSmem<T> nu_spread_smem(unsigned char* p,
                                                          int rec) {
  NuSpreadSmem<T> s;
  s.W = reinterpret_cast<T*>(p);
  s.C = s.W + NU_CHUNK * rec;
  s.list = reinterpret_cast<int4*>(s.C + 2 * NU_CHUNK);
  s.seg = reinterpret_cast<int*>(s.list + NU_CHUNK + NU_THREADS);
  s.pre = s.seg + NU_MAXSEG;
  s.warp = s.pre + NU_MAXSEG + 1;
  s.wlist = s.warp + NU_WARPS;
  return s;
}

// the layout above, or at the end the task's output over all of it
template <typename T>
static size_t nu_spread_smem_bytes(int rec, int cells) {
  const size_t stage = NU_CHUNK * (rec + 2) * sizeof(T) +
                       (NU_CHUNK + NU_THREADS) * sizeof(int4) +
                       (2 * NU_MAXSEG + 1 + NU_WARPS + NU_WARPS * NU_CHUNK) *
                           sizeof(int);
  const size_t tile = 2 * cells * sizeof(T);
  return stage > tile ? stage : tile;
}

// a staged record's stride for `used` values: a multiple of 16 bytes (the
// patches' 16-byte loads) and an odd one, so that the threads that stage
// different points spread over the banks (4-way, not 16- or 32-way)
template <typename T>
__host__ __device__ __forceinline__ int nu_record(int used) {
  const int vec = 16 / sizeof(T);
  const int rec = (used + vec - 1) / vec * vec;
  return rec % (2 * vec) == 0 ? rec + vec : rec;
}

// (o - i0) mod n for a left tap i0 with i0 + hw in [0, n): the cell o's
// place among the point's taps, counted from its left tap
template <int AX>
__device__ __forceinline__ int nu_rel(int o, int i0, const NuSpreadArgs& a) {
  int r = o - (i0 + a.hw);          // in (-n, n)
  r += r < 0 ? a.n[AX] : 0;
  r += a.hwm[AX];                    // in [0, 2n)
  return r >= a.n[AX] ? r - a.n[AX] : r;
}

// whether a point whose taps start rel cells before the task's origin
// reaches one of its e cells along axis AX
template <int AX>
__device__ __forceinline__ bool nu_reaches(int rel, int e,
                                           const NuSpreadArgs& a) {
  return rel < a.w || rel + e > a.n[AX];
}

// N consecutive staged values, by 16-byte loads where N allows
template <typename T, int N>
__device__ __forceinline__ void nu_load(const T* p, T (&v)[N]) {
  typedef typename NuVec2<T>::type V2;
  if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const V2 x = reinterpret_cast<const V2*>(p)[q];
      v[2 * q] = x.x; v[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = p[q];
  }
}

// A task's cells and the thread's patch among them.  The task is the box
// origin o, extent e; P planes along axis 0 and V rows along axis 1 (3-D)
// of b[L] cells along the last axis, cut into patches of RA rows (3-D) by
// RT cells, one a thread; a staged point's record is [last axis (b[L]) |
// axis 1 (V, 3-D) | axis 0 (P)].
template <int D>
struct NuTask {
  int o[D], e[D], lo[D], cn[D];
  int P, V, rec;
  int u, pv, pt;   // the thread's plane, patch row and patch column
  bool own;
};

// Stage the n reaching points list[0, n) and add them into the thread's
// patch; the chunk's sums go through part into acc.
template <typename T, int D, int RA, int RT>
__device__ __forceinline__ void nu_spread_chunk(
    const T* __restrict__ c, const int* __restrict__ perm,
    const T* __restrict__ off, const NuSpreadArgs& a,
    const NuSpreadSmem<T>& sm, const int4* list, int n, const NuTask<D>& t,
    T (&acc)[2 * RA * RT], T (&part)[2 * RA * RT]) {
  constexpr int L = D - 1;
#ifndef NU_TIME_NO_STAGE
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // zero the records, then a thread a (point, axis) adds each of its w ES
  // weights at the task's cell it lands on along the axis (two taps land
  // on one cell where a grid side is under w); the threads of axis 1 also
  // load the strength (through the permutation).
  const int bL = a.b[L];
  {
    typedef typename NuVec2<T>::type V2;
    V2* w2 = reinterpret_cast<V2*>(sm.W);
    for (int q = tid; q < n * t.rec / 2; q += NU_THREADS) w2[q] = V2();
  }
  __syncthreads();
  {
    const T beta = (T)a.beta, scale = (T)(2.0 / a.w);
    for (int item = tid; item < D * NU_CHUNK; item += NU_THREADS) {
      const int i = item % NU_CHUNK, ax = item / NU_CHUNK;
      if (i >= n) continue;
      const int4 q = list[i];
      int rel, nn, ext, span, base;
      if (ax == 0) {
        rel = q.y; nn = a.n[0]; ext = t.e[0]; span = t.P;
        base = bL + (D == 3 ? t.V : 0);
      } else if (ax == L) {
        rel = D == 3 ? q.w : q.z; nn = a.n[L]; ext = t.e[L]; span = bL;
        base = 0;
      } else {
        rel = q.z; nn = a.n[1]; ext = t.e[1]; span = t.V; base = bL;
      }
      T* rw = sm.W + i * t.rec + base;
      const T of = off[ax * a.M + q.x];
      for (int m = 0; m < a.w; ++m) {
        int s2 = m - rel;                 // the cell of tap m, mod nn
        s2 += s2 < 0 ? nn : 0;
        while (s2 >= nn) s2 -= nn;
        if (s2 < ext) rw[s2] += nu_weight(of, m, scale, beta);
      }
      if (ax == 1) {
        const long p = perm[q.x];
        sm.C[2 * i] = c[2 * p];
        sm.C[2 * i + 1] = c[2 * p + 1];
      }
    }
  }
  __syncthreads();
#ifndef NU_TIME_NO_ACC
  {
    // this warp's list of the staged points with a weight on its cells: a
    // ballot over 32 points at a time, testing the planes (and rows) the
    // warp's patches lie in
    int* mine = sm.wlist + warp * NU_CHUNK;
    const int runs = bL / RT, pvs = D == 3 ? t.V / RA : 1;
    const int r0 = (warp * 32) / runs, r1 = (warp * 32 + 31) / runs;
    const int u0 = r0 / pvs, u1 = r1 / pvs;
    const int v0 = u0 == u1 ? (r0 - u0 * pvs) * RA : 0;
    const int v1 = u0 == u1 ? (r1 - u1 * pvs) * RA + RA - 1 : t.V - 1;
    const int ul = u1 < t.P ? u1 : t.P - 1;
    const int b0 = bL + (D == 3 ? t.V : 0);      // axis 0 in a record
    int cnt = 0;
    for (int g = 0; g < n && u0 < t.P; g += 32) {
      const int i = g + lane;
      bool act = false;
      if (i < n) {
        const T* rw = sm.W + i * t.rec;
        for (int u = u0; u <= ul; ++u) act = act || rw[b0 + u] != T(0);
        if (D == 3) {
          bool any = false;
          for (int v = v0; v <= v1; ++v) any = any || rw[bL + v] != T(0);
          act = act && any;
        }
      }
      const unsigned b = __ballot_sync(0xffffffffu, act);
      if (act) mine[cnt + __popc(b & ((1u << lane) - 1u))] = i;
      cnt += __popc(b);
    }
    __syncwarp();
    const int pos0 = b0 + t.u, pos1 = bL + t.pv * RA, posL = t.pt * RT;
#pragma unroll 2
    for (int j = 0; j < cnt; ++j) {
      const int i = mine[j];
      const T* rw = sm.W + i * t.rec;
      const T s0 = rw[pos0];
      T w1[RA], wl[RT];
      if (D == 3) nu_load<T, RA>(rw + pos1, w1);
      else w1[0] = T(1);
      nu_load<T, RT>(rw + posL, wl);
      const T cr = sm.C[2 * i] * s0, ci = sm.C[2 * i + 1] * s0;
#pragma unroll
      for (int ra = 0; ra < RA; ++ra) {
        const T fr = cr * w1[ra], fi = ci * w1[ra];
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          part[2 * (ra * RT + q)] += fr * wl[q];
          part[2 * (ra * RT + q) + 1] += fi * wl[q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 2 * RA * RT; ++q) {
      acc[q] += part[q];
      part[q] = T(0);
    }
  }
#endif
  __syncthreads();
#endif
}

// One task (ops/nufft.py spread_tasks): task[0, D) origin, [D, 2D)
// extent, [2D, 3D) the first spread bin read per axis, [3D, 4D) how many;
// then P, V and the cells a thread, RA RT.
template <typename T, int D, int RA, int RT>
__device__ __forceinline__ void nu_spread_task(
    const T* __restrict__ c, T* __restrict__ g, const int* __restrict__ perm,
    const int* __restrict__ i0, const T* __restrict__ off,
    const int* __restrict__ sbstart, const int* __restrict__ sbcount,
    const int* __restrict__ task, const NuSpreadArgs& a,
    unsigned char* smem) {
  constexpr int L = D - 1;
  const NuSpreadSmem<T> sm = nu_spread_smem<T>(smem, a.rec);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  NuTask<D> t;
#pragma unroll
  for (int ax = 0; ax < D; ++ax) {
    t.o[ax] = task[ax]; t.e[ax] = task[D + ax];
    t.lo[ax] = task[2 * D + ax]; t.cn[ax] = task[3 * D + ax];
  }
  t.P = task[4 * D];
  t.V = task[4 * D + 1];
  t.rec = nu_record<T>(a.b[L] + t.P + (D == 3 ? t.V : 0));
  const int runs = a.b[L] / RT, pvs = D == 3 ? t.V / RA : 1;
  const int rest = tid / runs;
  t.pt = tid - rest * runs;
  t.u = rest / pvs;
  t.pv = rest - t.u * pvs;
  t.own = t.u < t.P;
  T acc[2 * RA * RT], part[2 * RA * RT];
#pragma unroll
  for (int q = 0; q < 2 * RA * RT; ++q) acc[q] = part[q] = T(0);
  long cells = a.n[0] * (long)a.n[1];
  if (D == 3) cells *= a.n[2];
  c += 2 * (long)blockIdx.y * a.M;
  g += 2 * (long)blockIdx.y * cells;

  // the spread bins read, row-major over the box lo + [0, cn): each one's
  // first sorted point, and a block-wide prefix of their counts
  int nseg = t.cn[0] * t.cn[1];
  if (D == 3) nseg *= t.cn[2];
  const int spt = (nseg + NU_THREADS - 1) / NU_THREADS;    // <= 4
  int cts[NU_MAXSEG / NU_THREADS], mine = 0;
#pragma unroll
  for (int q = 0; q < NU_MAXSEG / NU_THREADS; ++q) {
    const int s = tid * spt + q;
    cts[q] = 0;
    if (q < spt && s < nseg) {
      int rest = s, sb = 0, kk[D];
#pragma unroll
      for (int ax = D - 1; ax >= 0; --ax) {
        kk[ax] = rest % t.cn[ax];
        rest /= t.cn[ax];
      }
#pragma unroll
      for (int ax = 0; ax < D; ++ax) {
        int x = t.lo[ax] + kk[ax];
        x -= x >= a.ns[ax] ? a.ns[ax] : 0;
        sb = sb * a.ns[ax] + x;
      }
      sm.seg[s] = sbstart[sb];
      cts[q] = sbcount[sb];
      mine += cts[q];
    }
  }
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    incl += lane >= d ? y : 0;
  }
  if (lane == 31) sm.warp[warp] = incl;
  __syncthreads();
  int total = 0, before = 0;
#pragma unroll
  for (int q = 0; q < NU_WARPS; ++q) {
    const int m = sm.warp[q];
    before += q < warp ? m : 0;
    total += m;
  }
  int run = before + incl - mine;
#pragma unroll
  for (int q = 0; q < NU_MAXSEG / NU_THREADS; ++q) {
    const int s = tid * spt + q;
    if (q < spt && s < nseg) {
      sm.pre[s] = run;
      run += cts[q];
    }
  }
  if (tid == 0) sm.pre[nseg] = total;
  __syncthreads();

  // the candidates in that order, NU_THREADS at a time: keep those that
  // reach the task's cells, in order (a ballot and a prefix over the
  // warps), and stage them NU_CHUNK at a time
  int nlist = 0;
  for (int f0 = 0; f0 < total; f0 += NU_THREADS) {
    const int f = f0 + tid;
    bool reach = f < total;
    int4 q = make_int4(0, 0, 0, 0);
    if (reach) {
      int s0 = 0, s1 = nseg;
      while (s1 - s0 > 1) {
        const int mid = (s0 + s1) >> 1;
        if (sm.pre[mid] <= f) s0 = mid; else s1 = mid;
      }
      q.x = sm.seg[s0] + f - sm.pre[s0];
      q.y = nu_rel<0>(t.o[0], i0[q.x], a);
      q.z = nu_rel<1>(t.o[1], i0[a.M + q.x], a);
      reach = nu_reaches<0>(q.y, t.e[0], a) && nu_reaches<1>(q.z, t.e[1], a);
      if (D == 3) {
        q.w = nu_rel<L>(t.o[L], i0[L * a.M + q.x], a);
        reach = reach && nu_reaches<L>(q.w, t.e[L], a);
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, reach);
    if (lane == 0) sm.warp[warp] = __popc(bal);
    __syncthreads();
    int prior = 0, added = 0;
#pragma unroll
    for (int w2 = 0; w2 < NU_WARPS; ++w2) {
      const int m = sm.warp[w2];
      prior += w2 < warp ? m : 0;
      added += m;
    }
    if (reach) sm.list[nlist + prior + __popc(bal & ((1u << lane) - 1u))] = q;
    nlist += added;
    __syncthreads();
    if (nlist >= NU_CHUNK) {
      int head = 0;
      for (; nlist - head >= NU_CHUNK; head += NU_CHUNK)
        nu_spread_chunk<T, D, RA, RT>(c, perm, off, a, sm, sm.list + head,
                                 NU_CHUNK, t, acc, part);
      const int rest = nlist - head;            // < NU_CHUNK
      const int4 keep = tid < rest ? sm.list[head + tid] : q;
      __syncthreads();
      if (tid < rest) sm.list[tid] = keep;
      __syncthreads();
      nlist = rest;
    }
  }
  if (nlist > 0)
    nu_spread_chunk<T, D, RA, RT>(c, perm, off, a, sm, sm.list, nlist, t,
                                  acc, part);

  // the task's cells, each written once: the runs go through shared
  // memory (over the staging area) so that a warp stores whole rows
  typedef typename NuVec2<T>::type V2;
  V2* tile = reinterpret_cast<V2*>(smem);    // [P][V][b[L]] cells
  const int bL = a.b[L];
  if (t.own) {
#pragma unroll
    for (int ra = 0; ra < RA; ++ra) {
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        V2 x;
        x.x = acc[2 * (ra * RT + q)];
        x.y = acc[2 * (ra * RT + q) + 1];
        tile[(t.u * t.V + t.pv * RA + ra) * bL + t.pt * RT + q] = x;
      }
    }
  }
  __syncthreads();
  const int e1 = D == 3 ? t.e[1] : 1;
  const int nrow = t.e[0] * e1, eL = t.e[L];
  for (int q = tid; q < nrow * eL; q += NU_THREADS) {
    const int r = q / eL, col = q - r * eL;
    const int u = r / e1, v = r - u * e1;
    long base = (long)(t.o[0] + u) * a.n[1];
    if (D == 3) base = (base + t.o[1] + v) * a.n[2];
    reinterpret_cast<V2*>(g)[base + t.o[L] + col] =
        tile[(u * t.V + v) * bL + col];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NU_THREADS, 2)
nu_spread_kernel(const T* __restrict__ c, T* __restrict__ g,
                 const int* __restrict__ perm, const int* __restrict__ i0,
                 const T* __restrict__ off, const int* __restrict__ sbstart,
                 const int* __restrict__ sbcount,
                 const int* __restrict__ tasks, NuSpreadArgs a) {
  extern __shared__ __align__(16) unsigned char nu_smem[];
  const int* task = tasks + (long)blockIdx.x * (4 * D + 3);
  // R = RA RT: 1 to NU_RMAX (3-D) or NU_RMAX2 (2-D) cells a thread,
  // RT = min(R, 4) along the last axis
  switch (task[4 * D + 2]) {
    case 1:
      nu_spread_task<T, D, 1, 1>(c, g, perm, i0, off, sbstart, sbcount, task,
                                 a, nu_smem);
      break;
    case 2:
      nu_spread_task<T, D, 1, 2>(c, g, perm, i0, off, sbstart, sbcount, task,
                                 a, nu_smem);
      break;
    case 4:
      nu_spread_task<T, D, 1, 4>(c, g, perm, i0, off, sbstart, sbcount, task,
                                 a, nu_smem);
      break;
    default:
      if constexpr (D == 3) {
        if (task[4 * D + 2] == 8)
          nu_spread_task<T, D, 2, 4>(c, g, perm, i0, off, sbstart, sbcount,
                                     task, a, nu_smem);
        else
          nu_spread_task<T, D, 4, 4>(c, g, perm, i0, off, sbstart, sbcount,
                                     task, a, nu_smem);
      }
  }
}

template <typename T, int D>
static int nu_spread_launch(const void* c, void* g, const void* perm,
                            const void* i0, const void* off,
                            const void* sbstart, const void* sbcount,
                            const void* tasks, int ntask, int B,
                            const NuSpreadArgs& a, cudaStream_t stream) {
  const size_t smem = nu_spread_smem_bytes<T>(a.rec, a.cells);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nu_spread_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nu_spread_kernel<T, D><<<dim3(ntask, B), NU_THREADS, smem, stream>>>(
      (const T*)c, (T*)g, (const int*)perm, (const int*)i0, (const T*)off,
      (const int*)sbstart, (const int*)sbcount, (const int*)tasks, a);
  return (int)cudaGetLastError();
}

static int nu_spread_dispatch(int D, const void* c, void* g,
                              const void* perm, const void* i0,
                              const void* off, const void* sbstart,
                              const void* sbcount, const void* tasks,
                              int ntask, int B, int M, const int* n,
                              const int* b, const int* ns, int w,
                              double beta, int f64, void* stream) {
  if (ntask < 1 || B < 1 || B > 65535 || M < 1 || w < 2 || w > NU_MAXW)
    return (int)cudaErrorInvalidValue;
  NuSpreadArgs a;
  for (int ax = 0; ax < 3; ++ax) {
    const bool in = ax < D;
    a.n[ax] = in ? n[ax] : 1;
    a.b[ax] = in ? b[ax] : 1;
    a.ns[ax] = in ? ns[ax] : 1;
    if (a.n[ax] < 1 || a.b[ax] < 1 || a.b[ax] > 64 || a.ns[ax] < 1)
      return (int)cudaErrorInvalidValue;
    a.hwm[ax] = (w / 2) % a.n[ax];
  }
  a.w = w; a.hw = w / 2; a.M = M; a.beta = beta;
  a.cells = NU_THREADS * (D == 3 ? NU_RMAX : NU_RMAX2);
  const int used = a.b[D - 1] + a.b[0] + (D == 3 ? a.b[1] : 0);
  a.rec = f64 ? nu_record<double>(used) : nu_record<float>(used);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 2)
    return f64 ? nu_spread_launch<double, 2>(c, g, perm, i0, off, sbstart,
                                             sbcount, tasks, ntask, B, a, s)
               : nu_spread_launch<float, 2>(c, g, perm, i0, off, sbstart,
                                            sbcount, tasks, ntask, B, a, s);
  return f64 ? nu_spread_launch<double, 3>(c, g, perm, i0, off, sbstart,
                                           sbcount, tasks, ntask, B, a, s)
             : nu_spread_launch<float, 3>(c, g, perm, i0, off, sbstart,
                                          sbcount, tasks, ntask, B, a, s);
}

// --------------------------------------------------------------- interp --

// timing-only builds (wrong values; chip_smoke.py NU_INTERP_PHASES):
// NU_TIME_INTERP_NO_TAPS loads the subgrid and writes zeros,
// NU_TIME_INTERP_NO_LOAD runs the taps on whatever shared memory holds,
// NU_TIME_INTERP_LOAD_ONLY loads the subgrids and stops.  These builds,
// the spread's and the sweeps' (-D NU_INTERP_W7_ONLY) instantiate the
// interp at w = 7 only.
#if defined(NU_TIME_INTERP_NO_TAPS) || defined(NU_TIME_INTERP_NO_LOAD) || \
    defined(NU_TIME_NO_ACC) || defined(NU_TIME_INTERP_LOAD_ONLY)
#define NU_INTERP_W7_ONLY
#endif

#define NU_GROUP 16      // interp: lanes that sum one point's taps

struct NuInterpArgs {
  int n[3];       // grid sides
  int b[3];       // bin sides
  int nb[3];      // bins per axis
  int s[3];       // subgrid sides loaded: b + w - 1, the last axis rounded
                  // up to whole reads
  int sl;         // the subgrid's row pitch in cells (ops/nufft.py
                  // interp_subgrid)
  int a16;        // 1 where the grid's base address is 16-byte aligned
  int M;          // points
  double beta;
};

// How a point's group of NU_GROUP lanes reads its taps (ops/nufft.py
// tap_shape mirrors it): each lane reads C cells of the last axis in one
// 16-byte (f32 up to w = 7: two cells) or 8-byte read, from an aligned
// start, so L lanes cover a row's w taps; the group reads R rows a step,
// K steps a plane.  A shared-memory wavefront serves PH lanes.
template <typename T, int W>
struct NuTapShape {
  static constexpr int C = (sizeof(T) == 4 && W <= 7) ? 2 : 1;
  static constexpr int NEED = (W + 2 * C - 2) / C;
  static constexpr int L = NEED <= 2 ? 2 : NEED <= 4 ? 4 : NEED <= 8 ? 8 : 16;
  static constexpr int R = NU_GROUP / L;
  static constexpr int K = (W + R - 1) / R;
  static constexpr int PH = 128 / (C * 2 * (int)sizeof(T));
  // cells in 16 bytes; in float32 the subgrid's columns start X0 cells
  // left of the bin's halo and its rows hold an even count, so that a row
  // that lies inside the grid starts and ends on 16-byte boundaries
  static constexpr int E = 16 / (2 * (int)sizeof(T));
  static constexpr int X0 = E == 2 ? (W / 2) % 2 : 0;
};

template <typename T, int C> struct NuRead;
template <> struct NuRead<float, 2> { typedef float4 type; };
template <> struct NuRead<float, 1> { typedef float2 type; };
template <> struct NuRead<double, 1> { typedef double2 type; };

// one complex cell from global to shared memory, asynchronously
template <typename V2>
__device__ __forceinline__ void nu_cp_cell(V2* dst, const V2* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(V2) == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
}

// the weight of tap t along axis AX of the group's point: lane gl of the
// group evaluated tap gl % 8 of axis PER q + gl / 8 into phi[q] (PER = 2)
// or tap gl of axis q (PER = 1)
template <int AX, int PER, typename T, int ROUNDS>
__device__ __forceinline__ T nu_tap_weight(const T (&phi)[ROUNDS], int t) {
  return __shfl_sync(0xffffffffu, phi[AX / PER],
                     (PER == 2 ? (AX % PER) * 8 : 0) + t, NU_GROUP);
}

// mbarrier and bulk-copy (TMA) helpers, shared::cta addresses
__device__ __forceinline__ void nu_bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void nu_bar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void nu_bar_wait(unsigned bar, unsigned phase) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "NU_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra NU_WAIT;\n\t}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on the mbarrier bar
__device__ __forceinline__ void nu_bulk(unsigned dst, const void* src,
                                        unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Start copying a subgrid into sg: sides a.s, rows of a.sl cells, grid
// cells (o + index) mod n.  Each thread copies whole rows, walking its rows
// and their wrapped grid rows incrementally (no division a row).  Where
// every row is 16-byte aligned (bulk: float64, or an even last side in
// float32) a row is one bulk copy of the tensor memory accelerator, or two
// where it wraps along the last axis, all completing on the mbarrier bar;
// else a cp.async a cell, in one commit group.
template <typename T, int D, int W, int NT>
__device__ __forceinline__ void nu_interp_issue(
    const T* g, typename NuVec2<T>::type* sg, const int (&o)[D],
    const NuInterpArgs& a, bool bulk, unsigned bar) {
  typedef typename NuVec2<T>::type V2;
  constexpr int LA = D - 1;
  const int tid = threadIdx.x;
  const int s1 = D == 3 ? a.s[1] : 1, n1 = D == 3 ? a.n[1] : 1;
  const int sc = a.s[LA], nl = a.n[LA], ol = o[LA];
  if (bulk && tid == 0)
    nu_bar_expect(bar, (unsigned)(a.s[0] * s1 * sc * sizeof(V2)));
  // this thread's rows tid, tid + NT, ... as (u, v) and grid rows
  int u = tid / s1, v = tid - u * s1;
  const int du = NT / s1, dv = NT - du * s1;
  int gu = nu_wrap(o[0] + u, a.n[0]);
  int gv = D == 3 ? nu_wrap(o[1] + v, n1) : 0;
  for (; u < a.s[0];) {
    const V2* src = reinterpret_cast<const V2*>(g) + ((long)gu * n1 + gv) * nl;
    V2* dst = sg + (u * s1 + v) * a.sl;
    if (bulk) {
      const unsigned d0 = (unsigned)__cvta_generic_to_shared(dst);
      // the row's cells [ol, ol + sc) mod nl: one piece, or two
      const int c0 = ol < 0 ? ol + nl : ol;
      const int first = c0 + sc <= nl ? sc : nl - c0;
      nu_bulk(d0, src + c0, first * sizeof(V2), bar);
      if (first < sc)
        nu_bulk(d0 + first * sizeof(V2), src, (sc - first) * sizeof(V2), bar);
    } else {
      for (int col = 0; col < sc; ++col) {
        int c = ol + col;
        if (sc <= nl)
          c += c < 0 ? nl : c >= nl ? -nl : 0;
        else
          c = nu_wrap(c, nl);
        nu_cp_cell(dst + col, src + c);
      }
    }
    // the next row of this thread, NT rows on
    u += du;
    gu += du;
    if constexpr (D == 3) {
      v += dv;
      gv += dv;
      if (v >= s1) {
        v -= s1;
        gv -= s1;
        ++u;
        ++gu;
      }
      while (gv >= n1) gv -= n1;
      while (gv < 0) gv += n1;
    }
    while (gu >= a.n[0]) gu -= a.n[0];
  }
  if (!bulk) asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Taps by groups: NU_GROUP lanes sum one point's taps (NuTapShape), two
// points a warp at a time; each tap one 16- or 8-byte read, the rows of a
// wavefront on disjoint banks.
template <typename T, int D, int W, int NT>
__device__ __forceinline__ void nu_interp_group(
    const typename NuVec2<T>::type* sg, T* __restrict__ out,
    const int* __restrict__ perm, const int* __restrict__ i0,
    const T* __restrict__ off, const int (&o)[D], int first, int last,
    const NuInterpArgs& a) {
  typedef NuTapShape<T, W> S;
  typedef typename NuVec2<T>::type V2;
  typedef typename NuRead<T, S::C>::type VR;
  constexpr int LA = D - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // group grp of the warp, lane gl in it, reading row r, column pair /
  // cell j of each step.  The ES weights are each evaluated once in the
  // group (nu_tap_weight).  A group's point data are fetched an iteration
  // ahead, so their latency hides behind the taps of the point before.
  constexpr int PER = W <= 8 ? 2 : 1;
  constexpr int ROUNDS = (D + PER - 1) / PER;
  const int grp = lane >> 4, gl = lane & 15;
  const int r = gl / S::L, j = gl % S::L;
  const T beta = (T)a.beta, scale = (T)(2.0 / W);
  int nli[D], np;
  T noff[ROUNDS];
  auto fetch = [&](int bx) {
    const int pt = bx + grp < last ? bx + grp : last - 1;
#pragma unroll
    for (int ax = 0; ax < D; ++ax) nli[ax] = i0[ax * a.M + pt] - o[ax];
#pragma unroll
    for (int q = 0; q < ROUNDS; ++q) {
      const int ax = q * PER + (PER == 2 ? gl >> 3 : 0);
      noff[q] = ax < D ? off[ax * a.M + pt] : T(0);
    }
    np = perm[pt];
  };
  fetch(first + 2 * warp);
  for (int base = first + 2 * warp; base < last; base += NT / 16) {
    const bool valid = base + grp < last;    // an odd tail's idle group
    int li[D];
#pragma unroll
    for (int ax = 0; ax < D; ++ax) li[ax] = nli[ax];
    T of[ROUNDS];
#pragma unroll
    for (int q = 0; q < ROUNDS; ++q) of[q] = noff[q];
    const int p = np;
    fetch(base + NT / 16);
#ifdef NU_TIME_INTERP_NO_TAPS
    T re = a.M < 0 ? reinterpret_cast<const T*>(sg)[tid] + of[0] : T(0);
    T im = a.M < 0 ? T(li[0]) : T(0);
#else
    T phi[ROUNDS];
#pragma unroll
    for (int q = 0; q < ROUNDS; ++q) {
      const int ax = q * PER + (PER == 2 ? gl >> 3 : 0);
      const int t = PER == 2 ? gl & 7 : gl;
      phi[q] = ax < D && t < W ? nu_weight(of[q], t, scale, beta) : T(0);
    }
    // the last axis: C cells a lane from the aligned start; lanes past
    // the last tap read it again, with weight 0
    const int sh = li[LA] % S::C;
    const int jc = j < (W - 1 + sh) / S::C ? j : (W - 1 + sh) / S::C;
    T wl[S::C];
#pragma unroll
    for (int e = 0; e < S::C; ++e) {
      const int t = S::C * j + e - sh;
      const T v = nu_tap_weight<LA, PER>(phi, t < 0 ? 0 : t < W ? t : W - 1);
      wl[e] = t >= 0 && t < W ? v : T(0);
    }
    // the rows: row k R + r of each step, the last row again past w
    T wr[S::K];
    int ro[S::K];
#pragma unroll
    for (int k = 0; k < S::K; ++k) {
      const int t = k * S::R + r;
      const T v = nu_tap_weight<D - 2, PER>(phi, t < W ? t : W - 1);
      wr[k] = t < W ? v : T(0);
      ro[k] = (t < W ? t : W - 1) * a.sl;
    }
    const V2* p0 = sg + (D == 3 ? li[0] * a.s[1] + li[1] : li[0]) * a.sl +
                   li[LA] - sh + S::C * jc;
    const int plane = D == 3 ? a.s[1] * a.sl : 0;
    T acc[2 * S::C];
#pragma unroll
    for (int q = 0; q < 2 * S::C; ++q) acc[q] = T(0);
#pragma unroll
    for (int t1 = 0; t1 < (D == 3 ? W : 1); ++t1) {
      T part[2 * S::C];
#pragma unroll
      for (int q = 0; q < 2 * S::C; ++q) part[q] = T(0);
#pragma unroll
      for (int k = 0; k < S::K; ++k) {
        const VR v = *reinterpret_cast<const VR*>(p0 + t1 * plane + ro[k]);
        if constexpr (S::C == 2) {
          part[0] += v.x * wr[k]; part[1] += v.y * wr[k];
          part[2] += v.z * wr[k]; part[3] += v.w * wr[k];
        } else {
          part[0] += v.x * wr[k]; part[1] += v.y * wr[k];
        }
      }
      T w0 = T(1);
      if constexpr (D == 3) w0 = nu_tap_weight<0, PER>(phi, t1);
#pragma unroll
      for (int q = 0; q < 2 * S::C; ++q) acc[q] += part[q] * w0;
    }
    T re = acc[0] * wl[0], im = acc[1] * wl[0];
    if constexpr (S::C == 2) {
      re += acc[2] * wl[1];
      im += acc[3] * wl[1];
    }
    // the group's sum, in a fixed order: lanes 8-15 keep im, 0-7 re
    {
      const bool hi = gl & 8;
      T keep = hi ? im : re;
      keep += __shfl_xor_sync(0xffffffffu, hi ? re : im, 8);
      keep += __shfl_xor_sync(0xffffffffu, keep, 4);
      keep += __shfl_xor_sync(0xffffffffu, keep, 2);
      keep += __shfl_xor_sync(0xffffffffu, keep, 1);
      re = keep;
      im = __shfl_down_sync(0xffffffffu, keep, 8);
    }
#endif
    if (gl == 0 && valid) {
      V2 v;
      v.x = re;
      v.y = im;
      reinterpret_cast<V2*>(out)[p] = v;
    }
  }
}

// Taps by threads: a thread sums one point's w^d taps, each one 8- or
// 16-byte read, with two accumulator pairs (even and odd rows); the ES
// weights of each axis in registers.  The next point's data are fetched
// a point ahead.
template <typename T, int D, int W, int NT>
__device__ __forceinline__ void nu_interp_thread(
    const typename NuVec2<T>::type* sg, T* __restrict__ out,
    const int* __restrict__ perm, const int* __restrict__ i0,
    const T* __restrict__ off, const int (&o)[D], int first, int last,
    const NuInterpArgs& a) {
  typedef typename NuVec2<T>::type V2;
  const T beta = (T)a.beta, scale = (T)(2.0 / W);
  int nli[D], np;
  T noff[D];
  auto fetch = [&](int j) {
    const int pt = j < last ? j : last - 1;
#pragma unroll
    for (int ax = 0; ax < D; ++ax) {
      nli[ax] = i0[ax * a.M + pt] - o[ax];
      noff[ax] = off[ax * a.M + pt];
    }
    np = perm[pt];
  };
  fetch(first + threadIdx.x);
  for (int j = first + threadIdx.x; j < last; j += NT) {
    int li[D];
    T of[D];
#pragma unroll
    for (int ax = 0; ax < D; ++ax) {
      li[ax] = nli[ax];
      of[ax] = noff[ax];
    }
    const int p = np;
    fetch(j + NT);
#ifdef NU_TIME_INTERP_NO_TAPS
    T re = a.M < 0 ? reinterpret_cast<const T*>(sg)[threadIdx.x] + of[0]
                   : T(0);
    T im = a.M < 0 ? T(li[0]) : T(0);
#else
    T wt[D][W];
#pragma unroll
    for (int ax = 0; ax < D; ++ax)
#pragma unroll
      for (int t = 0; t < W; ++t) wt[ax][t] = nu_weight(of[ax], t, scale, beta);
    const V2* p0 = sg + (D == 3 ? li[0] * a.s[1] + li[1] : li[0]) * a.sl +
                   li[D - 1];
    const int plane = D == 3 ? a.s[1] * a.sl : 0;
    T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int t1 = 0; t1 < (D == 3 ? W : 1); ++t1) {
#pragma unroll
      for (int t2 = 0; t2 < W; ++t2) {
        const V2* row = p0 + t1 * plane + t2 * a.sl;
        T rr = T(0), ri = T(0);
#pragma unroll
        for (int t3 = 0; t3 < W; ++t3) {
          const V2 v = row[t3];
          rr += v.x * wt[D - 1][t3];
          ri += v.y * wt[D - 1][t3];
        }
        const T wr = D == 3 ? wt[0][t1] * wt[1][t2] : wt[0][t2];
        acc[2 * (t2 & 1)] += rr * wr;
        acc[2 * (t2 & 1) + 1] += ri * wr;
      }
    }
    const T re = acc[0] + acc[2], im = acc[1] + acc[3];
#endif
    V2 v;
    v.x = re;
    v.y = im;
    reinterpret_cast<V2*>(out)[p] = v;
  }
}

// The interp's frame, each choice measured on the H100
// (bench_nufft_interp.py; PERF.md); a -D of the same name overrides it:
//   - the taps by groups of NU_GROUP lanes a point in 3-D (343 taps at
//     w = 7), by a thread a point in 2-D (49 taps, fewer than a group's
//     weight shuffles and sum cost): NU_INTERP_GROUP_2D / _3D;
//   - a block a subproblem, its registers capped at 64 a thread so that
//     several fit an SM and one block's copy runs beside another's taps:
//     512 threads and two blocks an SM in 3-D, 128 threads and eight in
//     2-D: NU_INTERP_THREADS_2D / _3D, NU_INTERP_MINB_2D / _3D.
//     Persistent blocks that copy the next subproblem's subgrid into a
//     second buffer were slower on the paths' point sets.
#ifndef NU_INTERP_GROUP_2D
#define NU_INTERP_GROUP_2D 0
#endif
#ifndef NU_INTERP_GROUP_3D
#define NU_INTERP_GROUP_3D 1
#endif
#ifndef NU_INTERP_THREADS_2D
#define NU_INTERP_THREADS_2D 128
#endif
#ifndef NU_INTERP_THREADS_3D
#define NU_INTERP_THREADS_3D 512
#endif
#ifndef NU_INTERP_MINB_2D
#define NU_INTERP_MINB_2D 8
#endif
#ifndef NU_INTERP_MINB_3D
#define NU_INTERP_MINB_3D 2
#endif
template <int D> struct NuInterpFrame {
  static constexpr bool group =
      D == 3 ? NU_INTERP_GROUP_3D != 0 : NU_INTERP_GROUP_2D != 0;
  static constexpr int threads =
      D == 3 ? NU_INTERP_THREADS_3D : NU_INTERP_THREADS_2D;
  static constexpr int min_blocks =
      D == 3 ? NU_INTERP_MINB_3D : NU_INTERP_MINB_2D;
};

// One block per (subproblem, batch element): sub (bin, first point,
// count); copy the bin's subgrid, then sum its points' taps.
template <typename T, int D, int W>
__global__ void __launch_bounds__(NuInterpFrame<D>::threads,
                                  NuInterpFrame<D>::min_blocks)
nu_interp_kernel(const T* __restrict__ g, T* __restrict__ out,
                 const int* __restrict__ perm, const int* __restrict__ i0,
                 const T* __restrict__ off, const int* __restrict__ sub,
                 NuInterpArgs a) {
  typedef NuTapShape<T, W> S;
  typedef NuInterpFrame<D> F;
  typedef typename NuVec2<T>::type V2;
  constexpr int NT = F::threads;
  extern __shared__ __align__(16) unsigned char nu_smem[];
  __shared__ __align__(8) unsigned long long bar;
  V2* sg = reinterpret_cast<V2*>(nu_smem);
  int o[D];                        // the subgrid's origin: the bin's, less
  {                                // the halo (and X0 along the last axis)
    int rest = sub[3 * blockIdx.x];
#pragma unroll
    for (int ax = D - 1; ax >= 0; --ax) {
      const int c = ax > 0 ? rest % a.nb[ax] : rest;
      rest = ax > 0 ? rest / a.nb[ax] : 0;
      o[ax] = c * a.b[ax] - W / 2 - (ax == D - 1 ? S::X0 : 0);
    }
  }
  long cells = a.n[0] * (long)a.n[1];
  if constexpr (D == 3) cells *= a.n[2];
  g += 2 * (long)blockIdx.y * cells;
  out += 2 * (long)blockIdx.y * a.M;
#ifndef NU_TIME_INTERP_NO_LOAD
  {
#ifdef NU_INTERP_NO_BULK
    const bool bulk = false;
#else
    // every row 16-byte aligned, wrapping at most once
    const bool bulk = a.a16 && a.s[D - 1] <= a.n[D - 1] &&
                      (S::E == 1 || a.n[D - 1] % 2 == 0);
#endif
    const unsigned b = (unsigned)__cvta_generic_to_shared(&bar);
    if (bulk) {
      if (threadIdx.x == 0) nu_bar_init(b, 1);
      __syncthreads();
    }
    nu_interp_issue<T, D, W, NT>(g, sg, o, a, bulk, b);
    if (bulk)
      nu_bar_wait(b, 0);
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
#endif
  __syncthreads();
#ifndef NU_TIME_INTERP_LOAD_ONLY
  const int first = sub[3 * blockIdx.x + 1];
  const int last = first + sub[3 * blockIdx.x + 2];
  if constexpr (F::group)
    nu_interp_group<T, D, W, NT>(sg, out, perm, i0, off, o, first, last, a);
  else
    nu_interp_thread<T, D, W, NT>(sg, out, perm, i0, off, o, first, last, a);
#endif
}

template <typename T, int D, int W>
static int nu_interp_launch(const void* g, void* out, const void* perm,
                            const void* i0, const void* off, const void* sub,
                            int nsub, int B, NuInterpArgs a,
                            cudaStream_t stream) {
  typedef NuTapShape<T, W> S;
  typedef NuInterpFrame<D> F;
  for (int ax = 0; ax < D; ++ax) a.s[ax] = a.b[ax] + W - 1;
  a.s[D - 1] = (a.s[D - 1] + S::X0 + S::E - 1) / S::E * S::E;
  // the pitch: whole 16 bytes, and where one wavefront serves several
  // rows of a group (L < PH), rows that fall on disjoint banks
  int sl = a.s[D - 1];
  while (F::group && S::L < S::PH && (sl / S::C) % S::PH != S::L) sl += S::E;
  a.sl = sl;
  const size_t smem = (size_t)(D == 3 ? a.s[0] * a.s[1] : a.s[0]) * sl * 2 *
                      sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nu_interp_kernel<T, D, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nu_interp_kernel<T, D, W><<<dim3(nsub, B), F::threads, smem, stream>>>(
      (const T*)g, (T*)out, (const int*)perm, (const int*)i0, (const T*)off,
      (const int*)sub, a);
  return (int)cudaGetLastError();
}

// the launch at the plan's w, taps fixed at compile time
template <typename T, int D>
static int nu_interp_dispatch(const void* g, void* out, const void* perm,
                              const void* i0, const void* off,
                              const void* sub, int nsub, int B,
                              const NuInterpArgs& a, int w,
                              cudaStream_t s) {
#define NU_W(W)                                                            \
  case W:                                                                  \
    return nu_interp_launch<T, D, W>(g, out, perm, i0, off, sub, nsub, B,  \
                                     a, s);
  switch (w) {
#ifdef NU_INTERP_W7_ONLY
    NU_W(7)
#else
    NU_W(2) NU_W(3) NU_W(4) NU_W(5) NU_W(6) NU_W(7) NU_W(8) NU_W(9)
    NU_W(10) NU_W(11) NU_W(12) NU_W(13) NU_W(14) NU_W(15) NU_W(16)
#endif
  }
#undef NU_W
  return (int)cudaErrorInvalidValue;
}

static int nu_interp_run(int D, const void* g, void* out, const void* perm,
                         const void* i0, const void* off, const void* sub,
                         int nsub, int B, int M, const int* n, const int* b,
                         const int* nb, int w, double beta, int f64,
                         void* stream) {
  if (nsub < 1 || B < 1 || B > 65535 || M < 1 || w < 2 || w > NU_MAXW)
    return (int)cudaErrorInvalidValue;
  NuInterpArgs a;
  for (int ax = 0; ax < 3; ++ax) {
    const bool in = ax < D;
    a.n[ax] = in ? n[ax] : 1;
    a.b[ax] = in ? b[ax] : 1;
    a.nb[ax] = in ? nb[ax] : 1;
    a.s[ax] = 1;
    if (a.n[ax] < 1 || a.b[ax] < 1 || a.nb[ax] < 1)
      return (int)cudaErrorInvalidValue;
  }
  a.sl = 1; a.M = M; a.beta = beta;
  a.a16 = (reinterpret_cast<unsigned long long>(g) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 2)
    return f64 ? nu_interp_dispatch<double, 2>(g, out, perm, i0, off, sub,
                                               nsub, B, a, w, s)
               : nu_interp_dispatch<float, 2>(g, out, perm, i0, off, sub,
                                              nsub, B, a, w, s);
  return f64 ? nu_interp_dispatch<double, 3>(g, out, perm, i0, off, sub,
                                             nsub, B, a, w, s)
             : nu_interp_dispatch<float, 3>(g, out, perm, i0, off, sub, nsub,
                                            B, a, w, s);
}

extern "C" {

// g (B, n1, n2, 2) = the spread of the strengths c (B, M, 2); every cell is
// written, so g needs no zeroing.  perm (M,) int32, i0 (2, M) int32 and
// off (2, M) are the plan's sorted arrays; b1 x b2 the plan's bin; sbstart
// and sbcount (ns1 ns2,) int32 the first sorted point and the point count
// of each row-major spread bin; tasks (ntask, 11) int32 the plan's spread
// tasks (ops/nufft.py spread_tasks).  f64: 1 for double values and
// offsets, 0 for float.  Returns the error of the shared-memory opt-in, or
// cudaGetLastError() after the launch.
int nufft_spread2_launch(const void* c, void* g, const void* perm,
                         const void* i0, const void* off, const void* sbstart,
                         const void* sbcount, const void* tasks, int ntask,
                         int B, int M, int n1, int n2, int b1, int b2,
                         int ns1, int ns2, int w, double beta, int f64,
                         void* stream) {
  const int n[2] = {n1, n2}, b[2] = {b1, b2}, ns[2] = {ns1, ns2};
  return nu_spread_dispatch(2, c, g, perm, i0, off, sbstart, sbcount, tasks,
                            ntask, B, M, n, b, ns, w, beta, f64, stream);
}

// out (B, M, 2) = the interp of the grid g (B, n1, n2, 2) at the plan's
// points; perm, i0 and off as for nufft_spread2_launch, sub (nsub, 3) int32
// (bin, first, count) per subproblem of 32x32 bins, nb2 bins along axis 1.
int nufft_interp2_launch(const void* g, void* out, const void* perm,
                         const void* i0, const void* off, const void* sub,
                         int nsub, int B, int M, int n1, int n2, int nb2,
                         int w, double beta, int f64, void* stream) {
  const int n[2] = {n1, n2}, b[2] = {NU_BIN, NU_BIN};
  const int nb[2] = {(n1 + NU_BIN - 1) / NU_BIN, nb2};
  return nu_interp_run(2, g, out, perm, i0, off, sub, nsub, B, M, n, b, nb,
                       w, beta, f64, stream);
}

// g (B, n1, n2, n3, 2) = the spread of the strengths c (B, M, 2), every cell
// written; as nufft_spread2_launch with i0 and off (3, M), bins of b1 x b2 x
// b3 cells, ns1 x ns2 x ns3 spread bins and tasks (ntask, 15).
int nufft_spread3_launch(const void* c, void* g, const void* perm,
                         const void* i0, const void* off, const void* sbstart,
                         const void* sbcount, const void* tasks, int ntask,
                         int B, int M, int n1, int n2, int n3, int b1, int b2,
                         int b3, int ns1, int ns2, int ns3, int w,
                         double beta, int f64, void* stream) {
  const int n[3] = {n1, n2, n3}, b[3] = {b1, b2, b3};
  const int ns[3] = {ns1, ns2, ns3};
  return nu_spread_dispatch(3, c, g, perm, i0, off, sbstart, sbcount, tasks,
                            ntask, B, M, n, b, ns, w, beta, f64, stream);
}

// out (B, M, 2) = the interp of the grid g (B, n1, n2, n3, 2) at the plan's
// points; perm, i0 and off as for nufft_spread3_launch, sub (nsub, 3) int32
// (bin, first, count) per subproblem, the bin row-major over (n1/b1, nb2,
// nb3) bins of b1 x b2 x b3 cells.
int nufft_interp3_launch(const void* g, void* out, const void* perm,
                         const void* i0, const void* off, const void* sub,
                         int nsub, int B, int M, int n1, int n2, int n3,
                         int b1, int b2, int b3, int nb2, int nb3, int w,
                         double beta, int f64, void* stream) {
  const int n[3] = {n1, n2, n3}, b[3] = {b1, b2, b3};
  const int nb[3] = {b1 > 0 ? (n1 + b1 - 1) / b1 : 0, nb2, nb3};
  return nu_interp_run(3, g, out, perm, i0, off, sub, nsub, B, M, n, b, nb,
                       w, beta, f64, stream);
}

const char* nufft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
