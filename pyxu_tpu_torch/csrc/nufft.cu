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
// Interp: the cuFINUFFT subproblem method.  The plan splits bins of more
// than MAX_SUB points into subproblems, one block per (subproblem, batch
// element): load the bin's padded subgrid, the bin plus a w-1 halo per axis
// (wrapping), into shared memory; each thread sums one point's w^d taps and
// writes the result to the point's original index.  The 3-D interp is this
// shared-memory design too, not cuFINUFFT's global-memory gather; a 3-D
// subgrid above the 48 KB default opts in to more shared memory (up to
// 227 KB).  No TMA, no clusters.

#include <cuda_runtime.h>

#define NU_BIN 32        // 2-D bin side (grid cells); ops/nufft.py mirrors it
#define NU_MAXW 16       // most taps per axis
#define NU_THREADS 256   // ops/nufft.py THREADS
#define NU_WARPS (NU_THREADS / 32)
#define NU_CHUNK 128     // spread: points staged in shared memory at a time
#define NU_RMAX 16       // spread: most cells a thread owns in 3-D, and
#define NU_RMAX2 4       // in 2-D (ops/nufft.py MAX_RUN)

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
static int nu_interp_launch(const void* g, void* out, const void* perm,
                            const void* i0, const void* off, const void* sub,
                            int nsub, int B, const NuArgs& a,
                            cudaStream_t stream) {
  const int SS = NU_BIN + a.w - 1;
  const size_t smem = (size_t)2 * SS * SS * sizeof(T);   // <= 35,344 B
  nu_interp_kernel<T><<<dim3(nsub, B), NU_THREADS, smem, stream>>>(
      (const T*)g, (T*)out, (const int*)perm, (const int*)i0, (const T*)off,
      (const int*)sub, a);
  return (int)cudaGetLastError();
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
static int nu_interp3_launch(const void* g, void* out, const void* perm,
                             const void* i0, const void* off,
                             const void* sub, int nsub, int B,
                             const Nu3Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)2 * a.s1 * a.s2 * a.s3 * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nu_interp3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nu_interp3_kernel<T><<<dim3(nsub, B), NU_THREADS, smem, stream>>>(
      (const T*)g, (T*)out, (const int*)perm, (const int*)i0, (const T*)off,
      (const int*)sub, a);
  return (int)cudaGetLastError();
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
  if (nsub < 1 || B < 1 || B > 65535 || M < 1 || n1 < 1 || n2 < 1 ||
      nb2 < 1 || w < 2 || w > NU_MAXW)
    return (int)cudaErrorInvalidValue;
  NuArgs a;
  a.n1 = n1; a.n2 = n2; a.nb2 = nb2; a.w = w; a.hw = w / 2; a.M = M;
  a.beta = beta;
  cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return nu_interp_launch<double>(g, out, perm, i0, off, sub, nsub, B, a,
                                    s);
  return nu_interp_launch<float>(g, out, perm, i0, off, sub, nsub, B, a, s);
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
    return nu_interp3_launch<double>(g, out, perm, i0, off, sub, nsub, B, a,
                                     s);
  return nu_interp3_launch<float>(g, out, perm, i0, off, sub, nsub, B, a, s);
}

const char* nufft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
