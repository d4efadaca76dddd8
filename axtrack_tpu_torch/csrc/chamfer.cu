// Chamfer geodesic distance maps on Hopper (sm_90a), one warp per window.
//
// Replaces the TPU kernel axtrack_tpu/ops/geodesic_pallas.py:_chamfer_kernel
// (with its row relax _row_relax), launched there by _launch through
// pl.pallas_call. Same function, bit for bit: for every window n,
//   out[n] = `sweeps` Gauss-Seidel chamfer sweeps over crops[n]
// starting from d = 0 at local[n] and INF elsewhere (fresh variant), or from
// init[n] (continuation variant). A sweep scans the rows top->bottom, then
// bottom->top; per row cand = min(d, prev + 1), then the obstacle-respecting
// min-plus relax d[i] = min_j (cand[j] + |i - j|) over i's run of passable
// cells; blocked cells hold INF = 1e9. The plain PyTorch version is
// axtrack_tpu_torch/ops/geodesic.py:chamfer_plain.
//
// Arithmetic: every value is an integer in [0, 2^24) or exactly INF, so the
// kernel computes in int32 and converts to f32 on store, which is exact.
// The largest intermediate is INF + INF = 2e9 < 2^31, so nothing wraps.
//
// Design. A window's rows depend on each other (Gauss-Seidel), so the
// parallelism is across windows and along a row:
//  - one warp owns one window; lane l owns the E = W/32 (rounded up to a
//    power of two) contiguous columns [l*E, l*E + E). The previous row stays
//    in that lane's registers for the whole pass, and a lane only ever reads
//    back columns it wrote itself, so no barrier is needed anywhere.
//  - the row relax is two segmented min-plus scans: each lane scans its E
//    cells sequentially, the lanes combine their (c, k) summaries
//    (s -> min(c, s + k), the semigroup of geodesic.py:47-50) with five
//    shuffles, and each lane rescans its cells from the carry it received.
//  - the window's passable band (first and last row holding a passable
//    cell) is found in-kernel by one pass over the crop; rows outside it are
//    all blocked, stay INF and are written once, not swept. So no band sort
//    is needed, unlike the Pallas kernel whose programs cover 16 windows.
//  - crop bytes and distance rows stream through L2; nothing lives in
//    shared memory, so occupancy is bounded by registers only.
//
// Bound. Per window the function must read its W*W crop bytes (plus
// 4*W*W bytes of init for a continuation) and write 4*W*W bytes of
// distances: at W = 512, ~1.3 MB a window. Its arithmetic, ~10 integer
// operations per cell per pass, is far below the card's rate, so the bound
// is memory: about 1024 windows per 0.4 ms at 3.35 TB/s. This kernel moves
// more than that (each pass reads and writes the band's rows again, from
// L2 where they fit) and its row recurrence is latency-bound: one row's
// loads, scans and shuffles must finish before the next row starts. Many
// windows in flight (one warp each) are what hide that latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1000000000;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// f(s) = min(c, s + k): the effect of a stretch of cells on a value
// entering it. Identity: (INF, 0). A blocked cell: (INF, INF).
struct Fn {
  int c;
  int k;
};

__device__ __forceinline__ int sat(int v) { return v < kInf ? v : kInf; }

// apply a, then b
__device__ __forceinline__ Fn compose(Fn a, Fn b) {
  return Fn{min(b.c, sat(a.c + b.k)), sat(a.k + b.k)};
}

template <int E>
__device__ __forceinline__ void load_row(const uint8_t* crop_row,
                                         const float* d_row, int col0, int W,
                                         bool p[E], int v[E], bool read_d) {
  if constexpr (E >= 4) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      int col = col0 + 4 * q;
      if (col < W) {   // W % 8 == 0 and col % 4 == 0: all 4 are in bounds
        uint32_t bits = *reinterpret_cast<const uint32_t*>(crop_row + col);
        p[4 * q + 0] = (bits & 0x000000ffu) != 0;
        p[4 * q + 1] = (bits & 0x0000ff00u) != 0;
        p[4 * q + 2] = (bits & 0x00ff0000u) != 0;
        p[4 * q + 3] = (bits & 0xff000000u) != 0;
        if (read_d) {
          float4 f = *reinterpret_cast<const float4*>(d_row + col);
          v[4 * q + 0] = __float2int_rn(f.x);
          v[4 * q + 1] = __float2int_rn(f.y);
          v[4 * q + 2] = __float2int_rn(f.z);
          v[4 * q + 3] = __float2int_rn(f.w);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[4 * q + e] = false;
          if (read_d) v[4 * q + e] = kInf;
        }
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      int col = col0 + e;
      bool in = col < W;
      p[e] = in && crop_row[in ? col : 0] != 0;
      if (read_d) v[e] = in ? __float2int_rn(d_row[col]) : kInf;
    }
  }
}

template <int E>
__device__ __forceinline__ void store_row(float* d_row, int col0, int W,
                                          const int v[E]) {
  if constexpr (E >= 4) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      int col = col0 + 4 * q;
      if (col < W) {
        *reinterpret_cast<float4*>(d_row + col) =
            make_float4((float)v[4 * q + 0], (float)v[4 * q + 1],
                        (float)v[4 * q + 2], (float)v[4 * q + 3]);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (col0 + e < W) d_row[col0 + e] = (float)v[e];
  }
}

// Segmented min-plus relax of one row held across the warp: on return
// v[e] = min over the passable run around the cell of cand[j] + |i - j|,
// INF on blocked cells. cand values must be in [0, INF].
template <int E>
__device__ __forceinline__ void relax_row(const bool p[E], int v[E],
                                         int lane) {
  // left -> right: the lane's summary, then the carry from lanes < lane
  Fn f{kInf, 0};
#pragma unroll
  for (int e = 0; e < E; ++e)
    f = compose(f, p[e] ? Fn{v[e], 1} : Fn{kInf, kInf});
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int c = __shfl_up_sync(kFull, f.c, off);
    int k = __shfl_up_sync(kFull, f.k, off);
    if (lane >= off) f = compose(Fn{c, k}, f);
  }
  int carry_l = __shfl_up_sync(kFull, f.c, 1);
  if (lane == 0) carry_l = kInf;

  // right -> left
  Fn g{kInf, 0};
#pragma unroll
  for (int e = E - 1; e >= 0; --e)
    g = compose(g, p[e] ? Fn{v[e], 1} : Fn{kInf, kInf});
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int c = __shfl_down_sync(kFull, g.c, off);
    int k = __shfl_down_sync(kFull, g.k, off);
    if (lane + off < 32) g = compose(Fn{c, k}, g);
  }
  int carry_r = __shfl_down_sync(kFull, g.c, 1);
  if (lane == 31) carry_r = kInf;

  int fwd[E];
  int run = carry_l;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run = p[e] ? min(v[e], run + 1) : kInf;
    fwd[e] = run;
  }
  run = carry_r;
#pragma unroll
  for (int e = E - 1; e >= 0; --e) {
    run = p[e] ? min(v[e], run + 1) : kInf;
    v[e] = p[e] ? min(fwd[e], run) : kInf;
  }
}

template <int E>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
chamfer_kernel(const uint8_t* __restrict__ crops,
               const int* __restrict__ local,
               const float* __restrict__ init, float* __restrict__ out,
               int n_windows, int W, int sweeps) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (n >= n_windows) return;            // uniform across the warp

  const size_t plane = (size_t)W * W;
  const uint8_t* crop = crops + n * plane;
  float* d = out + n * plane;
  const float* d0 = init ? init + n * plane : nullptr;
  const int sy = local[2 * n], sx = local[2 * n + 1];
  const int col0 = lane * E;

  // passable band of this window
  int lo = W, hi = -1;
  for (int r = 0; r < W; ++r) {
    bool p[E];
    int unused[E];
    load_row<E>(crop + (size_t)r * W, nullptr, col0, W, p, unused, false);
    bool any = false;
#pragma unroll
    for (int e = 0; e < E; ++e) any |= p[e];
    if (__any_sync(kFull, any)) {
      lo = min(lo, r);
      hi = r;
    }
  }

  // rows outside the band are all blocked: INF from the first sweep on
  int inf_row[E];
#pragma unroll
  for (int e = 0; e < E; ++e) inf_row[e] = kInf;
  for (int r = 0; r < W; ++r)
    if (r < lo || r > hi) store_row<E>(d + (size_t)r * W, col0, W, inf_row);

  for (int s = 0; s < sweeps; ++s) {
    for (int dir = 0; dir < 2; ++dir) {
      int prev[E];
#pragma unroll
      for (int e = 0; e < E; ++e) prev[e] = kInf;
      const bool fresh = (s == 0 && dir == 0 && d0 == nullptr);
      const float* src = (s == 0 && dir == 0 && d0 != nullptr) ? d0 : d;
      for (int i = lo; i <= hi; ++i) {
        const int r = dir == 0 ? i : hi - (i - lo);
        bool p[E];
        int v[E];
        load_row<E>(crop + (size_t)r * W, src + (size_t)r * W, col0, W, p,
                    v, !fresh);
        if (fresh) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            v[e] = (r == sy && col0 + e == sx) ? 0 : kInf;
        }
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] = min(v[e], prev[e] + 1);
        relax_row<E>(p, v, lane);
        store_row<E>(d + (size_t)r * W, col0, W, v);
#pragma unroll
        for (int e = 0; e < E; ++e) prev[e] = v[e];
      }
    }
  }
}

template <int E>
cudaError_t launch(const uint8_t* crops, const int* local, const float* init,
                   float* out, int n_windows, int W, int sweeps,
                   cudaStream_t stream) {
  dim3 block(32 * kWarpsPerBlock);
  dim3 grid((n_windows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  chamfer_kernel<E><<<grid, block, 0, stream>>>(crops, local, init, out,
                                                n_windows, W, sweeps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// crops: uint8 [n, W, W] (nonzero = passable, source cells forced);
// local: int32 [n, 2]; init: f32 [n, W, W] or NULL (fresh);
// out: f32 [n, W, W]. W % 8 == 0, 8 <= W <= 1024, sweeps >= 1.
// Returns cudaGetLastError() after the launch (0 = launched).
int axt_chamfer(const void* crops, const void* local, const void* init,
                void* out, int n_windows, int W, int sweeps, void* stream) {
  auto c = static_cast<const uint8_t*>(crops);
  auto l = static_cast<const int*>(local);
  auto i = static_cast<const float*>(init);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_windows <= 0) return 0;
  if (W % 8 != 0 || W < 8 || W > 1024 || sweeps < 1)
    return (int)cudaErrorInvalidValue;
  const int per_lane = (W + 31) / 32;
  if (per_lane <= 1) return (int)launch<1>(c, l, i, o, n_windows, W, sweeps, s);
  if (per_lane <= 2) return (int)launch<2>(c, l, i, o, n_windows, W, sweeps, s);
  if (per_lane <= 4) return (int)launch<4>(c, l, i, o, n_windows, W, sweeps, s);
  if (per_lane <= 8) return (int)launch<8>(c, l, i, o, n_windows, W, sweeps, s);
  if (per_lane <= 16)
    return (int)launch<16>(c, l, i, o, n_windows, W, sweeps, s);
  return (int)launch<32>(c, l, i, o, n_windows, W, sweeps, s);
}

}  // extern "C"
