// The conv-block epilogue on Hopper (sm_90a): conv bias, eval-mode
// BatchNorm, leaky ReLU and, where the block is followed by a 2x2 max-pool,
// that pool, in one pass over the convolution's output.
//
// Replaces no Pallas kernel: the JAX package (axtrack_tpu/models/yolo.py)
// leaves the epilogue to XLA, which fuses it into the convolution's output.
// Run eagerly, PyTorch takes four passes for it (the bias add after
// cudnn_convolution, cuDNN's BatchNorm inference, the activation, the
// pool), each reading and writing every element. The plain PyTorch version
// is axtrack_tpu_torch/ops/epilogue_cuda.py:epilogue_plain.
//
// Function, for x f32 [N, C, H, W] (the convolution without its bias) and
// each channel c's conv bias b, BatchNorm gamma, beta, running mean and
// variance, eps, and the leaky slope a:
//   t = x + b;  y = (t - mean) * (gamma / sqrt(var + eps)) + beta;
//   out = y > 0 ? y : y * a;
// with pool, the max of the four activated values of each 2x2 window,
// out [N, C, H / 2, W / 2] (floor; an odd last row or column is dropped),
// a NaN in a window giving NaN, as max_pool2d gives. Arithmetic is f32 in
// that order: the add and the subtraction are rounded as PyTorch rounds
// them, the channel's factor gamma / sqrt(var + eps) is one correctly
// rounded sqrt and division (no rsqrt approximation), and the last
// multiply-add is one fmaf. cuDNN's BatchNorm forms its factors in its own
// order, so the result agrees with the four library calls to a few ulps.
//
// Bound. It does ~6 f32 operations an element, so bytes bound it on this
// card: each conv output element is read once and each activated (or
// pooled) element written once. At the deployed spec (conv
// 20-40-80-M-80-80-M-80-80-M-160 over 512-px tiles of 5 channels, 1,300
// tiles a call) that is 21.5 GB read and 14.8 GB written, 36.3 GB a call,
// 10.8 ms at 3.35 TB/s, where the four passes it replaces move ~140 GB.
//
// Layout, and what it does about that:
//  - A block works on one channel (blockIdx.x), so each thread forms the
//    channel's two factors once, in registers, from the five parameter
//    vectors: no host launch prepares them. blockIdx.y splits the
//    channel's N planes, taken one after another as a flat range of items
//    that the blocks stride through, among enough blocks that the grid
//    holds about kBlocksPerSm blocks an SM; small planes (16x16 at the
//    160-channel layer) are so packed several to a block. (Many short
//    blocks, one chunk of a channel each, were 13% slower on the H100:
//    each block then forms its factors and indexes anew for 1,024 items.)
//  - An item is 16 bytes along W: a float4 of one plane (no pool), or two
//    float4s of rows 2r and 2r + 1 giving one float2 of pooled row r.
//    Neighbouring threads take neighbouring items, so a warp reads whole
//    512-byte runs of a row. x must be 16-byte aligned (the caching
//    allocator's tensors are). Where a plane (no pool) or a row (pool) is
//    not a whole number of float4s, as at odd widths, items are single
//    elements or single pooled outputs (kVec = false).
//  - Each thread issues the loads of its kUnroll items (a grid stride
//    apart) before it uses any of them, so enough bytes are in flight to
//    cover the memory's latency. Plain loads: streaming ones
//    (ld.global.cs) were ~4% slower on the H100.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 8;

struct Channel {
  float bias, mean, scale, beta, slope;
};

__device__ __forceinline__ float activate(float x, const Channel& f) {
  const float t = x + f.bias;
  const float y = fmaf(t - f.mean, f.scale, f.beta);
  return y > 0.0f ? y : y * f.slope;
}

// max_pool2d's max: a value replaces the running max when it is larger or
// NaN, scanning the window row by row (from -inf, which the first value
// always replaces or equals).
__device__ __forceinline__ float pool_max(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

__device__ __forceinline__ float max4(float a, float b, float c, float d) {
  return pool_max(pool_max(pool_max(a, b), c), d);
}

// Items a plane: 16-byte items (kVec) or single elements, pooled output
// pairs or single pooled outputs (kPool).
template <bool kVec, bool kPool>
__host__ __device__ __forceinline__ long long plane_items(int H, int W) {
  if (kPool) return (long long)(H / 2) * (kVec ? W / 4 : W / 2);
  return kVec ? (long long)H * W / 4 : (long long)H * W;
}

// kVec: items of 16 bytes (see above); kPool: 2x2 max-pool after the
// activation. Block (c, j) takes items j * kThreads + threadIdx.x + k *
// gridDim.y * kThreads of channel c, whose N * plane_items items number
// below 2^31.
template <bool kVec, bool kPool>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(const float* __restrict__ x, float* __restrict__ out,
                const float* __restrict__ conv_bias,
                const float* __restrict__ gamma,
                const float* __restrict__ beta,
                const float* __restrict__ mean,
                const float* __restrict__ var, float eps, float slope,
                int N, int C, int H, int W) {
  const int c = blockIdx.x;
  Channel f;
  f.bias = conv_bias[c];
  f.mean = mean[c];
  f.scale = gamma[c] / sqrtf(var[c] + eps);
  f.beta = beta[c];
  f.slope = slope;

  const int Wo = kPool ? W / 2 : W;
  const unsigned row_items = kPool ? (kVec ? W / 4 : Wo) : 1;
  const unsigned per_plane = (unsigned)plane_items<kVec, kPool>(H, W);
  const unsigned total = (unsigned)N * per_plane;
  const unsigned stride = gridDim.y * kThreads;
  const long long in_plane = (long long)H * W;
  const long long out_plane = kPool ? (long long)(H / 2) * Wo : in_plane;
  for (unsigned base = blockIdx.y * kThreads + threadIdx.x; base < total;
       base += kUnroll * stride) {
    // the items' offsets, then every load, then the arithmetic
    long long src[kUnroll], dst[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned i = base + u * stride;
      live[u] = i < total;
      const unsigned n = i / per_plane, q = i - n * per_plane;
      const long long plane = (long long)n * C + c;
      if (kPool) {
        const unsigned r = q / row_items, k = q - r * row_items;
        src[u] = plane * in_plane + 2LL * r * W + (kVec ? 4 * k : 2 * k);
        dst[u] = plane * out_plane + (long long)r * Wo + (kVec ? 2 * k : k);
      } else {
        src[u] = plane * in_plane + (kVec ? 4LL * q : q);
        dst[u] = plane * out_plane + (kVec ? 4LL * q : q);
      }
    }
    if (kVec) {
      float4 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!live[u]) continue;
        a[u] = *reinterpret_cast<const float4*>(x + src[u]);
        if (kPool)
          b[u] = *reinterpret_cast<const float4*>(x + src[u] + W);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!live[u]) continue;
        const float4 v = a[u];
        if (kPool) {
          const float4 w = b[u];
          float2 o;
          o.x = max4(activate(v.x, f), activate(v.y, f), activate(w.x, f),
                     activate(w.y, f));
          o.y = max4(activate(v.z, f), activate(v.w, f), activate(w.z, f),
                     activate(w.w, f));
          *reinterpret_cast<float2*>(out + dst[u]) = o;
        } else {
          float4 o;
          o.x = activate(v.x, f);
          o.y = activate(v.y, f);
          o.z = activate(v.z, f);
          o.w = activate(v.w, f);
          *reinterpret_cast<float4*>(out + dst[u]) = o;
        }
      }
    } else {
      float a[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!live[u]) continue;
        a[u][0] = x[src[u]];
        if (kPool) {
          a[u][1] = x[src[u] + 1];
          a[u][2] = x[src[u] + W];
          a[u][3] = x[src[u] + W + 1];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!live[u]) continue;
        out[dst[u]] =
            kPool ? max4(activate(a[u][0], f), activate(a[u][1], f),
                         activate(a[u][2], f), activate(a[u][3], f))
                  : activate(a[u][0], f);
      }
    }
  }
}

template <bool kVec, bool kPool>
cudaError_t launch(const float* x, float* out, const float* conv_bias,
                   const float* gamma, const float* beta, const float* mean,
                   const float* var, float eps, float slope, int N, int C,
                   int H, int W, int n_sms, cudaStream_t stream) {
  const long long total = (long long)N * plane_items<kVec, kPool>(H, W);
  if (total >= (1LL << 31)) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  // about kBlocksPerSm blocks an SM in all, none of them without an item
  long long per_channel = ((long long)n_sms * kBlocksPerSm + C - 1) / C;
  const long long needed = (total + kThreads - 1) / kThreads;
  if (per_channel > needed) per_channel = needed;
  if (per_channel > 65535) per_channel = 65535;
  dim3 grid(C, (unsigned)per_channel);
  epilogue_kernel<kVec, kPool><<<grid, kThreads, 0, stream>>>(
      x, out, conv_bias, gamma, beta, mean, var, eps, slope, N, C, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: f32 [N, C, H, W], contiguous; out: f32 [N, C, H / 2, W / 2] with
// pool, else [N, C, H, W]; conv_bias, gamma, beta, mean, var: f32 [C].
// x must be 16-byte aligned; items are 16 bytes where H * W (no pool) or
// W (pool) is a multiple of 4. n_sms: the card's SM count. Returns
// cudaGetLastError() after the launch (0 = launched).
int axt_epilogue(const void* x, void* out, const void* conv_bias,
                 const void* gamma, const void* beta, const void* mean,
                 const void* var, float eps, float slope, int N, int C,
                 int H, int W, int pool, int n_sms, void* stream) {
  auto xi = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  auto b = static_cast<const float*>(conv_bias);
  auto g = static_cast<const float*>(gamma);
  auto be = static_cast<const float*>(beta);
  auto m = static_cast<const float*>(mean);
  auto v = static_cast<const float*>(var);
  auto s = static_cast<cudaStream_t>(stream);
  if (N < 0 || C < 1 || H < 0 || W < 0 || n_sms < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (pool ? W % 4 == 0 : ((long long)H * W) % 4 == 0) {
    return pool ? (int)launch<true, true>(xi, o, b, g, be, m, v, eps, slope,
                                          N, C, H, W, n_sms, s)
                : (int)launch<true, false>(xi, o, b, g, be, m, v, eps, slope,
                                           N, C, H, W, n_sms, s);
  }
  return pool ? (int)launch<false, true>(xi, o, b, g, be, m, v, eps, slope,
                                         N, C, H, W, n_sms, s)
              : (int)launch<false, false>(xi, o, b, g, be, m, v, eps, slope,
                                          N, C, H, W, n_sms, s);
}

}  // extern "C"
