// Chamfer geodesic distance maps on Hopper (sm_90a), read straight from a
// bit-packed mask, with the exactness certificate in the last pass.
//
// Replaces the TPU kernel axtrack_tpu/ops/geodesic_pallas.py:_chamfer_kernel
// (with its row relax _row_relax), launched there by _launch through
// pl.pallas_call, together with the crop gather (_crops_for) and the
// certificate (_locally_consistent) around it. Same function, bit for bit:
// for every window n with origin (oy, ox) in the padded mask,
//   out[n] = `sweeps` Gauss-Seidel chamfer sweeps over the window's cells
//            (the source cell local[n] forced passable when it lies inside
//            the window), starting from d = 0 at the source and INF
//            elsewhere (fresh variant), or from init[n] (continuation);
//   ok[n]  = 1 when every passable cell with d > 0 has d <= min(its four
//            neighbours) + 1 (neighbours outside the window count as INF),
//            else 0: the maps are upper bounds, so ok[n] = 1 certifies that
//            they are the exact geodesic distances.
// A sweep scans the rows top->bottom, then bottom->top; per row
// cand = min(d, prev + 1), then the obstacle-respecting min-plus relax
// d[i] = min_j (cand[j] + |i - j|) over i's run of passable cells; blocked
// cells hold INF = 1e9. The plain PyTorch version is
// axtrack_tpu_torch/ops/geodesic_cuda.py:chamfer_windows_plain.
//
// Arithmetic: every value is an integer in [0, 2^24) or exactly INF, and
// f32 add and min are exact on those integers, with INF + k rounding to INF
// for small k and every sum with an INF term staying >= INF. So the kernel
// computes in f32 like the Pallas kernel, with no conversions, and each
// min against a cell value <= INF gives the integer answer bit for bit.
// The certificate test d - min(neighbours) > 1.5 is the f32 test
// d > nb + 1.5 of _locally_consistent on these values.
//
// Bound (chip_smoke.py: k1_bound_ms). The function must write its W*W maps
// (4 bytes a cell), read init when continuing, and read the bitmap: at the
// main path's W = 512 and 512 windows, 537 MB, 0.16 ms at 3.35 TB/s. Its
// ~15 f32 operations per band cell per pass take about half that at the
// f32 lane rate. So bytes bound it; but the time is set by the window with
// the longest band: 2 * sweeps * band rows dependent row steps, each a
// full-row segmented min-plus scan. The design is about that latency.
//
// Design, and what each choice does about it:
//  - The mask is 1 bit a cell (rows padded to whole 32-bit words plus one
//    spare word), packed once per mask and shared by every window and
//    flush: 2.3 MB at 2920x6364, so it stays in L2. No crops tensor exists:
//    a thread takes its E columns of a row from the two words that hold
//    them, joined with __funnelshift_r (two 32-bit reads: a 64-bit read at
//    an odd word index would be misaligned).
//  - The band (first and last row holding a passable cell) comes from a
//    separate kernel, chamfer_bands_kernel: one block a window, one row a
//    thread, each row's words loaded independently, so many loads are in
//    flight and nothing walks the rows one after another. Rows outside the
//    band are written INF once and never swept, which is exact.
//  - The windows start longest band first (the host sorts the bands), and
//    each block asks for enough shared memory that at most 1, 2 or 4
//    blocks share an SM: at 1, the long windows, which set the time, never
//    share an SM's issue slots and memory pipe with other windows' row
//    steps. The host takes the fewest that still let the bands' total
//    rows, spread over the SMs, finish within the longest band's rows.
//  - A window belongs to WPW warps (4 at W = 512: 4 cells a thread). The
//    previous row stays in registers for the whole pass. The row relax:
//    each thread runs its cells left->right and right->left from INF, the
//    warp joins the threads' runs with a segmented min-scan each way (5
//    shuffles; the segments end at threads holding a blocked cell, found
//    with one ballot), the warps of a window join theirs through shared
//    memory and one named barrier (bar.sync id, 32*WPW) a row, and the
//    carries then enter each cell in parallel.
//  - A ring of kStages stages a thread in shared memory, filled with
//    cp.async (non-bulk: each thread copies exactly the words it reads
//    itself, 16 bytes a copy for the d rows and 4 for the two mask words,
//    so a cp.async.wait_group and no barrier or mbarrier is needed; the
//    bulk copy's async proxy would also need a proxy fence before
//    re-reading rows just stored). The copies for step j + 4 are issued in
//    step j, after that step has stored the previous row: the d rows that a
//    later pass (or a continuation's first pass) reads are in flight for
//    four row steps. A pass's first row is the row the previous pass ended
//    on, and its second row was stored too recently for its copy to see
//    it: both come from registers.
//  - A row's store and the next copies sit between the lane-local runs and
//    the shuffles of the next row, where they fill the shuffles' latency.
//  - The certificate is computed in the last (upward) pass: a row's left
//    and right neighbours come from the thread's own cells and one shuffle
//    each side, its lower neighbour is the previous row still in
//    registers, and its upper neighbour is the next row of the pass, so a
//    row is certified one step after it is final. ok[n] is one vote.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInfF = 1e9f;     // INF, exact in f32
constexpr int kAhead = 4;          // steps a copy is issued ahead
constexpr int kStages = kAhead + 1;
constexpr int kBlockThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

template <int K>
struct IntTag {
  static constexpr int value = K;
};

__host__ __device__ constexpr uint32_t low_bits(int m) {
  return m >= 32 ? 0xffffffffu : ((1u << m) - 1u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy BYTES from global to shared memory; only the first src_bytes are
// read (0: none), the rest is zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// barrier over the WPW warps of one window (named barrier `id`)
template <int WPW>
__device__ __forceinline__ void window_sync(int id) {
  if constexpr (WPW > 1)
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(32 * WPW) : "memory");
}

// Shared memory of one window, in 32-bit words: the d-row ring
// [stage][chunk][thread][CW], the mask-word ring [stage][2][thread], and
// the exchange area of the window's warps [parity][warp][8].
template <int E, int WPW>
struct Layout {
  static constexpr int T = 32 * WPW;
  static constexpr int CW = E < 4 ? E : 4;   // floats a copy
  static constexpr int NC = E / CW;          // copies a row
  static constexpr int kRingD = kStages * T * E;
  static constexpr int kRingM = kStages * 2 * T;
  static constexpr int kX = 2 * WPW * 8;
  static constexpr int kWords = kRingD + kRingM + kX;
  static constexpr int kWindows = kBlockThreads / T;   // windows a block
  static constexpr size_t kBytes = sizeof(int) * kWords * kWindows;
};

template <int E, int WPW>
__global__ void __launch_bounds__(kBlockThreads)
chamfer_kernel(const uint32_t* __restrict__ bits, int row_words, int n_rows,
               const int* __restrict__ origins,
               const int* __restrict__ local,
               const int* __restrict__ order, const int* __restrict__ bands,
               const float* __restrict__ init, float* __restrict__ out,
               int* __restrict__ ok, int n_windows, int W, int sweeps) {
  using L = Layout<E, WPW>;
  constexpr int T = L::T, CW = L::CW, NC = L::NC;
  extern __shared__ __align__(16) int smem[];

  const int g = threadIdx.x / T;          // window of the block
  const int t = threadIdx.x % T;          // thread of the window
  const int lane = threadIdx.x & 31;
  const int wv = t >> 5;                  // warp of the window
  const int slot = blockIdx.x * L::kWindows + g;
  if (slot >= n_windows) return;          // uniform over the window
  const int n = order[slot];              // longest band first
  const int bar = 1 + g;

  float* ring_d = reinterpret_cast<float*>(smem + g * L::kWords);
  uint32_t* ring_m = reinterpret_cast<uint32_t*>(ring_d + L::kRingD);
  int* xch = reinterpret_cast<int*>(ring_m + L::kRingM);

  const int oy = origins[2 * n], ox = origins[2 * n + 1];
  const int sy = local[2 * n], sx = local[2 * n + 1];
  const bool inside = sy >= 0 && sy < W && sx >= 0 && sx < W;
  const int c0 = t * E;
  const bool active = c0 < W;
  const uint32_t colmask = active ? low_bits(W - c0) & low_bits(E) : 0u;
  float* const dmap = out + (size_t)n * W * W;
  const float* const d0 = init ? init + (size_t)n * W * W : nullptr;

  // this thread's columns of the maps (and of init); a thread past the
  // window's right edge (W < 32 * WPW * E) keeps column 0 and never copies
  float* const d_self = dmap + (active ? c0 : 0);
  const float* const i_self = d0 ? d0 + (active ? c0 : 0) : d_self;
  auto chunk_in = [&](int q) { return c0 + q * CW < W; };

  auto store_row = [&](int r, const float* v) {
    float* const dst = d_self + r * W;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      if (chunk_in(q)) {
        if constexpr (CW == 4)
          *reinterpret_cast<float4*>(dst + 4 * q) =
              make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
        else if constexpr (CW == 2)
          *reinterpret_cast<float2*>(dst + 2 * q) =
              make_float2(v[2 * q], v[2 * q + 1]);
        else
          dst[q] = v[q];
      }
    }
  };
  float inf_row[E];
#pragma unroll
  for (int e = 0; e < E; ++e) inf_row[e] = kInfF;

  // a window whose origin leaves the bitmap is a caller's error: flag it
  const bool valid = oy >= 0 && ox >= 0 && oy + W <= n_rows &&
                     ((ox + W - 1) >> 5) + 1 < row_words;
  if (!valid) {
    for (int r = 0; r < W; ++r) store_row(r, inf_row);
    if (t == 0) ok[n] = -1;
    return;
  }

  // the passable band, from chamfer_bands_kernel
  const uint32_t* const base = bits + (size_t)oy * row_words;
  const int lo = bands[2 * n], hi = bands[2 * n + 1];

  // rows outside the band hold no passable cell: INF from the first sweep
  if (active) {
    for (int r = 0; r < lo; ++r) store_row(r, inf_row);
    for (int r = max(hi + 1, lo); r < W; ++r) store_row(r, inf_row);
  }

  // ---- the sweeps: 2 * sweeps passes of nb row steps, one ring
  const int nb = hi - lo + 1;             // <= 0: nothing passable
  const int npass = 2 * sweeps;
  const int n_steps = nb > 0 ? npass * nb : 0;
  const uint32_t* const wsrc0 = base + ((ox + c0) >> 5);

  // Copies for the next step to issue (row ir, index ii of its pass),
  // branch-free: a step past the end, or a pass's first row (it comes from
  // registers), copies a valid row whose words are never read; the first
  // pass of a fresh run copies no d row (source size 0).
  const uint32_t* const m_self = active ? wsrc0 : bits;
  const int mbytes = active ? 4 : 0;
  int ir = lo, idir = 1, ii = 0, jn = 0;
  const float* isrc = i_self;
  int dbytes = d0 ? 4 * CW : 0;
  auto issue = [&]() {
    const int s = jn % kStages;
    const int r = min(max(ir, lo), hi);
    const uint32_t* w = m_self + r * row_words;
    cp_async<4>(&ring_m[(s * 2) * T + t], w, mbytes);
    cp_async<4>(&ring_m[(s * 2 + 1) * T + t], w + 1, mbytes);
    const float* src = isrc + r * W;
#pragma unroll
    for (int q = 0; q < NC; ++q)
      cp_async<4 * CW>(&ring_d[((s * NC + q) * T + t) * CW],
                       src + (chunk_in(q) ? q * CW : 0),
                       chunk_in(q) ? dbytes : 0);
    cp_commit();
    ++jn;
    if (++ii == nb) {                     // the next pass starts on this row
      ii = 0;
      idir = -idir;
      isrc = d_self;
      dbytes = 4 * CW;
    } else {
      ir += idir;
    }
  };
  if (nb > 0)
    for (int jj = 0; jj < kAhead; ++jj) issue();

  // A row's inputs from the ring: its passable bits (source forced) and
  // its d values.
  auto fetch_bits = [&](int jj, int r) {
    const int s = jj % kStages;
    uint32_t pb = __funnelshift_r(ring_m[(s * 2) * T + t],
                                  ring_m[(s * 2 + 1) * T + t],
                                  (ox + c0) & 31) & colmask;
    if (inside && r == sy && sx >= c0 && sx < c0 + E) pb |= 1u << (sx - c0);
    return pb;
  };
  auto fetch_d = [&](int jj, float* vin) {
    const int s = jj % kStages;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const bool in = chunk_in(q);
      const float* src = &ring_d[((s * NC + q) * T + t) * CW];
      if constexpr (CW == 4) {
        const float4 f4 = *reinterpret_cast<const float4*>(src);
        vin[4 * q] = in ? f4.x : kInfF;
        vin[4 * q + 1] = in ? f4.y : kInfF;
        vin[4 * q + 2] = in ? f4.z : kInfF;
        vin[4 * q + 3] = in ? f4.w : kInfF;
      } else {
#pragma unroll
        for (int e = 0; e < CW; ++e) vin[q * CW + e] = in ? src[e] : kInfF;
      }
    }
  };

  // prev: the last row's values, stored one step later (row pend; the
  // first step stores INF over row lo, which the second step overwrites);
  // hold: a pass's second-to-last row, kept for the next pass's second row
  float prev[E], hold[E], m[E];
  uint32_t pbits = 0, pbits_prev = 0;
  int pend = lo;
  float viol = 0.f;                       // max of d - min(neighbours)
#pragma unroll
  for (int e = 0; e < E; ++e) {
    prev[e] = hold[e] = kInfF;
    m[e] = kInfF;
  }
  int j = 0;

  // one pass of nb row steps; KIND 0: first pass of a fresh run, 1: first
  // pass from init, 2: a later pass, 3: the last pass (with certificate)
  auto pass = [&](auto kind_tag, int p) {
    constexpr int KIND = decltype(kind_tag)::value;
    const int dir = (p & 1) ? -1 : 1;
    int r = (p & 1) ? hi : lo;
    if constexpr (KIND == 3) pbits_prev = 0;   // no row below the band
    for (int i = 0; i < nb; ++i, ++j, r += dir) {
      // A pass's first row is the row the previous pass ended on (cand =
      // min(d, d + 1) = d), and its second row was stored too recently for
      // its copy (issued kAhead steps ahead) to see: both from registers.
      float vin[E];
      if (KIND >= 2 && i == 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) vin[e] = prev[e];
      } else {
        cp_wait<kAhead - 1>();
        pbits = fetch_bits(j, r);
        if (KIND == 0) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            vin[e] = (r == sy && c0 + e == sx) ? 0.f : kInfF;
        } else if (KIND >= 2 && i == 1) {
#pragma unroll
          for (int e = 0; e < E; ++e) vin[e] = hold[e];
        } else {
          fetch_d(j, vin);
        }
      }

      // cand; the lane-local runs from INF both ways (f0, b0); and the
      // distance from each cell to the lane's left / right edge through
      // passable cells (lw, rw; >= INF across a blocked cell)
      float f0[E], b0[E], lw[E], rw[E];
      {
        float x[E], w[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const bool pe = pbits & (1u << e);
          x[e] = pe ? fminf(vin[e], prev[e] + 1.f) : kInfF;
          w[e] = pe ? 1.f : kInfF;
        }
        float run = kInfF, dist = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          run = fminf(x[e], run + w[e]);
          dist += w[e];
          f0[e] = run;
          lw[e] = dist;
        }
        run = kInfF;
        dist = 0.f;
#pragma unroll
        for (int e = E - 1; e >= 0; --e) {
          run = fminf(x[e], run + w[e]);
          dist += w[e];
          b0[e] = run;
          rw[e] = dist;
        }
      }
      // Segmented min-scans over the lanes of the carries: from the left
      // of c - E*lane, from the right of c + E*lane, each over the lanes
      // back to (and including) the nearest lane that is not all
      // passable. INF stays INF, so no rounding at INF brings a carry
      // below it.
      const bool full = pbits == low_bits(E);
      const uint32_t broken = __ballot_sync(kFull, !full);
      const uint32_t below = broken & (0xffffffffu >> (31 - lane));
      const uint32_t above = broken & (0xffffffffu << lane);
      const int seg_lo = below ? 31 - __clz(below) : 0;
      const int seg_hi = above ? __ffs(above) - 1 : 31;
      float uf = f0[E - 1] < kInfF ? f0[E - 1] - (float)(E * lane) : kInfF;
      float ub = b0[0] < kInfF ? b0[0] + (float)(E * lane) : kInfF;

      // the previous row's store and the copies for step j + kAhead
      // (after that store), while the scan's shuffles are in flight
      store_row(pend, prev);
      issue();

#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float tf = __shfl_up_sync(kFull, uf, off);
        const float tb = __shfl_down_sync(kFull, ub, off);
        if (lane - off >= seg_lo) uf = fminf(uf, tf);
        if (lane + off <= seg_hi) ub = fminf(ub, tb);
      }
      const float sf = __shfl_up_sync(kFull, uf, 1);
      const float sb = __shfl_down_sync(kFull, ub, 1);
      float cl = lane > 0 && sf < kInfF ? sf + (float)(E * (lane - 1)) : kInfF;
      float cr = lane < 31 && sb < kInfF ? sb - (float)(E * (lane + 1)) : kInfF;
      if constexpr (WPW > 1) {
        // the warps' carries out of their last / first cell, and whether
        // the whole warp is passable, through shared memory
        float* const xs = reinterpret_cast<float*>(xch) + (j & 1) * WPW * 8;
        if (lane == 31) {
          xs[wv * 8] = uf < kInfF ? uf + (float)(E * 31) : kInfF;
          xs[wv * 8 + 1] = broken ? kInfF : (float)(32 * E);
        }
        if (lane == 0) xs[wv * 8 + 2] = ub;
        window_sync<WPW>(bar);
        float in_l = kInfF, in_r = kInfF;
#pragma unroll
        for (int w = 0; w < WPW; ++w)
          if (w < wv) in_l = fminf(xs[w * 8], in_l + xs[w * 8 + 1]);
#pragma unroll
        for (int w = WPW - 1; w >= 0; --w)
          if (w > wv) in_r = fminf(xs[w * 8 + 2], in_r + xs[w * 8 + 1]);
        // a lane takes the warp's carry when every lane before it (after
        // it) in the warp is all passable
        if (!(broken & ~(0xffffffffu << lane)))
          cl = fminf(cl, in_l + (float)(E * lane));
        if (!(broken & ~(0xffffffffu >> (31 - lane))))
          cr = fminf(cr, in_r + (float)(E * (31 - lane)));
      }

      float v[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[e] = fminf(fminf(f0[e], cl + lw[e]), fminf(b0[e], cr + rw[e]));

      if constexpr (KIND == 3) {
        // Certificate. Row r + 1 (prev) is final now that row r, its upper
        // neighbour, is: a passable cell of it violates when
        // d - min(neighbours) > 1.5 (d > 0.5 adds nothing: min >= 0).
        // Row r's partial minimum m takes its lower neighbour (prev; INF
        // below the band) and its own row.
        float lft = __shfl_up_sync(kFull, v[E - 1], 1);
        float rgt = __shfl_down_sync(kFull, v[0], 1);
        if (lane == 0) lft = kInfF;
        if (lane == 31) rgt = kInfF;
        float el = kInfF, er = kInfF;
        if constexpr (WPW > 1) {
          const float* xp =
              reinterpret_cast<const float*>(xch) + ((j - 1) & 1) * WPW * 8;
          if (lane == 0 && wv > 0) el = xp[(wv - 1) * 8 + 5];
          if (lane == 31 && wv < WPW - 1) er = xp[(wv + 1) * 8 + 4];
        }
        const float below_add = i == 0 ? kInfF : 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float nbm = fminf(m[e], v[e]);
          if (e == 0) nbm = fminf(nbm, el);
          if (e == E - 1) nbm = fminf(nbm, er);
          const float d = pbits_prev & (1u << e) ? prev[e] : 0.f;
          viol = fmaxf(viol, d - nbm);
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float l = e > 0 ? v[e - 1] : lft;
          const float rr = e < E - 1 ? v[e + 1] : rgt;
          m[e] = fminf(fminf(l, rr), prev[e] + below_add);
        }
        if constexpr (WPW > 1) {
          float* const xs = reinterpret_cast<float*>(xch) + (j & 1) * WPW * 8;
          if (lane == 0) xs[wv * 8 + 4] = v[0];
          if (lane == 31) xs[wv * 8 + 5] = v[E - 1];
        }
      }
      pend = r;
      pbits_prev = pbits;
#pragma unroll
      for (int e = 0; e < E; ++e) prev[e] = v[e];
      if (i == nb - 2) {
#pragma unroll
        for (int e = 0; e < E; ++e) hold[e] = v[e];
      }
    }
  };
  if (nb > 0) {
    if (d0)
      pass(IntTag<1>{}, 0);
    else
      pass(IntTag<0>{}, 0);
    for (int p = 1; p < npass - 1; ++p) pass(IntTag<2>{}, p);
    if constexpr (WPW > 1) {
      // no edge values below the band for the last pass's first row
      float* const xf = reinterpret_cast<float*>(xch);
      if (lane == 0) xf[((j - 1) & 1) * WPW * 8 + wv * 8 + 4] = kInfF;
      if (lane == 31) xf[((j - 1) & 1) * WPW * 8 + wv * 8 + 5] = kInfF;
    }
    pass(IntTag<3>{}, npass - 1);
    store_row(pend, prev);

    // the band's first row: its upper neighbour is INF
    float el = kInfF, er = kInfF;
    if constexpr (WPW > 1) {
      window_sync<WPW>(bar);
      const float* xp =
          reinterpret_cast<const float*>(xch) + ((j - 1) & 1) * WPW * 8;
      if (lane == 0 && wv > 0) el = xp[(wv - 1) * 8 + 5];
      if (lane == 31 && wv < WPW - 1) er = xp[(wv + 1) * 8 + 4];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float nbm = m[e];
      if (e == 0) nbm = fminf(nbm, el);
      if (e == E - 1) nbm = fminf(nbm, er);
      const float d = pbits_prev & (1u << e) ? prev[e] : 0.f;
      viol = fmaxf(viol, d - nbm);
    }
  }
  cp_wait<0>();
  int any_bad = __any_sync(kFull, viol > 1.5f);
  if constexpr (WPW > 1) {
    window_sync<WPW>(bar);                // the edge reads above are done
    if (lane == 0) xch[wv] = any_bad;
    window_sync<WPW>(bar);
#pragma unroll
    for (int w = 0; w < WPW; ++w) any_bad |= xch[w];
  }
  if (t == 0) ok[n] = any_bad ? 0 : 1;
}

// The passable band of each window: the first and last of its rows that
// hold a passable cell (the source row counts when the source lies in the
// window), or (W, -1) when none does. One block a window, one row a
// thread, the row's words loaded independently of each other, so many
// loads are in flight and no per-row loop depends on the last.
__global__ void __launch_bounds__(kBlockThreads)
chamfer_bands_kernel(const uint32_t* __restrict__ bits, int row_words,
                     int n_rows, const int* __restrict__ origins,
                     const int* __restrict__ local, int* __restrict__ bands,
                     int W) {
  __shared__ int part[2 * kBlockThreads / 32];
  const int n = blockIdx.x, t = threadIdx.x, lane = t & 31;
  const int oy = origins[2 * n], ox = origins[2 * n + 1];
  const int sy = local[2 * n], sx = local[2 * n + 1];
  const bool inside = sy >= 0 && sy < W && sx >= 0 && sx < W;
  const bool valid = oy >= 0 && ox >= 0 && oy + W <= n_rows &&
                     ((ox + W - 1) >> 5) + 1 < row_words;
  const uint32_t* const base = bits + (size_t)oy * row_words;
  const int q_lo = ox >> 5, q_hi = (ox + W - 1) >> 5;
  const uint32_t m_first = 0xffffffffu << (ox & 31);
  const uint32_t m_last = low_bits(((ox + W - 1) & 31) + 1);
  int lo = W, hi = -1;
  for (int r = t; r < W && valid; r += kBlockThreads) {
    const uint32_t* row = base + (size_t)r * row_words;
    uint32_t any = __ldg(row + q_lo) & m_first;
    if (q_hi == q_lo) {
      any &= m_last;
    } else {
#pragma unroll 8
      for (int q = q_lo + 1; q < q_hi; ++q) any |= __ldg(row + q);
      any |= __ldg(row + q_hi) & m_last;
    }
    if (inside && r == sy) any = 1u;
    if (any) {
      lo = min(lo, r);
      hi = r;
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    part[2 * (t >> 5)] = lo;
    part[2 * (t >> 5) + 1] = hi;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kBlockThreads / 32; ++w) {
      lo = min(lo, part[2 * w]);
      hi = max(hi, part[2 * w + 1]);
    }
    bands[2 * n] = lo;
    bands[2 * n + 1] = hi;
  }
}

// Dynamic shared memory a block asks for, so that at most blocks_per_sm
// blocks (1, 2 or 4) fit in an SM's 228 KB. Windows run longest band
// first; with one block an SM the long windows, whose row recurrence sets
// the kernel's time, never share an SM's issue slots and memory pipe, and
// the short ones follow as SMs free up. The host picks more blocks an SM
// when the bands' total would keep one block an SM busy for longer than
// the longest band takes.
inline int block_smem(int blocks_per_sm, size_t need) {
  const int cap = blocks_per_sm <= 1 ? 116 * 1024
                  : blocks_per_sm == 2 ? 80 * 1024 : 48 * 1024;
  return need > (size_t)cap ? (int)need : cap;
}

template <int E, int WPW>
cudaError_t launch(const uint32_t* bits, int row_words, int n_rows,
                   const int* origins, const int* local, const int* order,
                   const int* bands, const float* init, float* out, int* ok,
                   int n_windows, int W, int sweeps, int blocks_per_sm,
                   cudaStream_t stream) {
  using L = Layout<E, WPW>;
  auto kernel = chamfer_kernel<E, WPW>;
  const int smem = block_smem(blocks_per_sm, L::kBytes);
  // The limit is the kernel's, shared by every host thread: each sets the
  // largest a launch of it may ask for (one block an SM), never its own
  // smem, or another thread's smaller limit could land between this call
  // and the launch below and fail it with cudaErrorInvalidValue.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      block_smem(1, L::kBytes));
  if (err != cudaSuccess) return err;
  dim3 grid((n_windows + L::kWindows - 1) / L::kWindows);
  kernel<<<grid, kBlockThreads, smem, stream>>>(
      bits, row_words, n_rows, origins, local, order, bands, init, out, ok,
      n_windows, W, sweeps);
  return cudaGetLastError();
}

template <int WPW>
cudaError_t dispatch(const uint32_t* bits, int row_words, int n_rows,
                     const int* origins, const int* local, const int* order,
                     const int* bands, const float* init, float* out,
                     int* ok, int n_windows, int W, int sweeps,
                     int blocks_per_sm, cudaStream_t s) {
  const int per_thread = (W + 32 * WPW - 1) / (32 * WPW);
#define AXT_LAUNCH(E)                                                     \
  return launch<E, WPW>(bits, row_words, n_rows, origins, local, order,  \
                        bands, init, out, ok, n_windows, W, sweeps,        \
                        blocks_per_sm, s)
  if (per_thread <= 1) AXT_LAUNCH(1);
  if (per_thread <= 2) AXT_LAUNCH(2);
  if (per_thread <= 4) AXT_LAUNCH(4);
  if (per_thread <= 8) AXT_LAUNCH(8);
  if (per_thread <= 16) AXT_LAUNCH(16);
  AXT_LAUNCH(32);
#undef AXT_LAUNCH
}

}  // namespace

extern "C" {

// bits: uint32 [n_rows, row_words], bit c % 32 of word c / 32 of a row is
// mask column c (1 = passable); every window's columns [ox, ox + W) must
// satisfy (ox + W - 1) / 32 + 1 < row_words (the spare word).
// origins, local: int32 [n, 2] (y, x); bands: int32 [n, 2] out.
// Returns cudaGetLastError() after the launch (0 = launched).
int axt_chamfer_bands(const void* bits, int row_words, int n_rows,
                      const void* origins, const void* local, void* bands,
                      int n_windows, int W, void* stream) {
  if (n_windows <= 0) return 0;
  if (W % 8 != 0 || W < 8 || W > 1024 || row_words < 2)
    return (int)cudaErrorInvalidValue;
  chamfer_bands_kernel<<<n_windows, kBlockThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), row_words, n_rows,
      static_cast<const int*>(origins), static_cast<const int*>(local),
      static_cast<int*>(bands), W);
  return (int)cudaGetLastError();
}

// As above, plus order: int32 [n], a permutation of the windows (the
// order their blocks start in); bands: int32 [n, 2] from
// axt_chamfer_bands; init: f32 [n, W, W] or NULL (fresh); out: f32
// [n, W, W]; ok: int32 [n] (1 certified, 0 not, -1 origin outside the
// bitmap). W % 8 == 0, 8 <= W <= 1024, sweeps >= 1, warps_per_window 1, 2
// or 4, blocks_per_sm 1, 2 or 4. Returns cudaGetLastError() after the
// launch (0 = launched).
int axt_chamfer(const void* bits, int row_words, int n_rows,
                const void* origins, const void* local, const void* order,
                const void* bands, const void* init, void* out, void* ok,
                int n_windows, int W, int sweeps, int warps_per_window,
                int blocks_per_sm, void* stream) {
  auto b = static_cast<const uint32_t*>(bits);
  auto o = static_cast<const int*>(origins);
  auto l = static_cast<const int*>(local);
  auto od = static_cast<const int*>(order);
  auto bd = static_cast<const int*>(bands);
  auto i = static_cast<const float*>(init);
  auto d = static_cast<float*>(out);
  auto k = static_cast<int*>(ok);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_windows <= 0) return 0;
  if (W % 8 != 0 || W < 8 || W > 1024 || sweeps < 1 || row_words < 2 ||
      (blocks_per_sm != 1 && blocks_per_sm != 2 && blocks_per_sm != 4))
    return (int)cudaErrorInvalidValue;
  switch (warps_per_window) {
    case 1:
      return (int)dispatch<1>(b, row_words, n_rows, o, l, od, bd, i, d, k,
                              n_windows, W, sweeps, blocks_per_sm, s);
    case 2:
      return (int)dispatch<2>(b, row_words, n_rows, o, l, od, bd, i, d, k,
                              n_windows, W, sweeps, blocks_per_sm, s);
    case 4:
      return (int)dispatch<4>(b, row_words, n_rows, o, l, od, bd, i, d, k,
                              n_windows, W, sweeps, blocks_per_sm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
