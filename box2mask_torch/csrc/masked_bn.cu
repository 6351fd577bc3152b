// Masked batch norm + ReLU (+ residual) for Hopper (sm_90a), forward and
// backward, bound through a plain C interface (ctypes;
// box2mask_torch/sparse/_build.py builds this file; the wrapper and the
// plain twin are box2mask_torch/sparse/masked_bn.py).
//
//   y = act( (x - mean) * (inv * scale) + bias  [+ residual] ),
//   inv = rsqrt(var + eps), act ReLU or the identity,
//
// with the batch moments of the valid rows in training and the running
// statistics in eval. Replaces no TPU kernel: box2mask_tpu leaves batch
// norm to XLA (nn/modules.py MaskedBatchNorm, sparse/ops.py
// masked_moments), which fuses it there; in eager PyTorch the same formula
// was ~30 kernels a BN forward and as many in autograd's backward, most of
// them full f32 passes over rows x channels.
//
// Bound on the H100: bytes over 3.35 TB/s; a few flops an element. The
// kernels read and write each element in its own dtype (bf16 under
// --bf16_acts) with 16-byte vector accesses of 8 channels, and keep every
// per-channel quantity in f32:
//   * bn_sums_kernel: per-block partial column sums s1, s2 of the valid rows
//     (reads x once; padded rows are skipped);
//   * bn_reduce_kernel: sums the partials in a fixed order (no float
//     atomics, so a step repeats bit for bit), then, unless a process group
//     all-reduces the sums first (bn_finalize_kernel then), the per-channel
//     mean, inv, the clamp flag and the running statistics' update;
//   * bn_norm_kernel: one pass over every row (x, residual in; y out);
//   * bn_bwd_sums_kernel: partial sums of g' = g * [y > 0] (or g) and of
//     g' * xhat over every row, padded rows included (the formula
//     normalizes every row, so their gradient enters dscale, dbias and the
//     moments' gradient); bn_reduce_kernel sums them;
//   * bn_dx_kernel: dx = a g' - valid * (a / n) (Sg' + xhat Sg'xhat [clamp
//     passes]) and dresidual = g'.
// The rounding follows the plain formula: y is rounded to its dtype after
// the normalization and again after the residual add (a sum of two tensors
// of that dtype), and the normalization and the running statistics are
// computed op by op without contraction (__f*_rn).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;            // channels per thread access (16 B of bf16)
constexpr int MAXC = 1024;        // channels the per-channel shared arrays hold
constexpr int UNROLL = 4;         // rows or elements in flight per thread

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __float22bfloat162_rn(make_float2(v[2 * i], v[2 * i + 1]));
  *reinterpret_cast<uint4*>(p) = u;
}

// 8 channels as loaded (16 bytes of bf16, 32 of f32), kept packed until
// used: the element kernels keep UNROLL of them per operand in flight
template <typename T> struct Raw8;
template <> struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ float operator[](int i) const {
    const float4& h = i < 4 ? a : b;
    switch (i & 3) {
      case 0: return h.x;
      case 1: return h.y;
      case 2: return h.z;
      default: return h.w;
    }
  }
};
template <> struct Raw8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float operator[](int i) const {
    const unsigned w = i < 2 ? u.x : i < 4 ? u.y : i < 6 ? u.z : u.w;
    return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
  }
};

// v rounded to T's precision and back (nearest even), as a cast to T does
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float inv_std(float var, float eps) {
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// Per-block column sums (s, t) of `rows` rows from the block's own
// contiguous chunk: thread (lane, v) holds 8 channels v*8.. of every
// lanes-th row; the lanes' sums meet in shared memory and are added in lane
// order. part row blockIdx.x gets [s (c), t (c)].
template <typename F>
__device__ __forceinline__ void block_sums(float (&s)[VEC], float (&t)[VEC],
                                           float* part, int c, F&& rows_fn) {
  __shared__ float red[THREADS * 2 * VEC];
  const int cv = c / VEC, lanes = THREADS / cv;
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = t[i] = 0.f;
  if ((int)threadIdx.x < lanes * cv) rows_fn((int)threadIdx.x / cv, lanes,
                                            (int)threadIdx.x % cv);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red[threadIdx.x * 2 * VEC + i] = s[i];
    red[threadIdx.x * 2 * VEC + VEC + i] = t[i];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * c; j += THREADS) {
    const int which = j / c, ch = j % c;
    const int base = (ch / VEC) * 2 * VEC + which * VEC + ch % VEC;
    float acc = 0.f;
    for (int l = 0; l < lanes; ++l) acc += red[l * cv * 2 * VEC + base];
    part[(size_t)blockIdx.x * 2 * c + j] = acc;
  }
}

template <typename X>
__global__ void __launch_bounds__(THREADS)
bn_sums_kernel(const X* __restrict__ x, const uint8_t* __restrict__ valid,
               float* __restrict__ part, int rows, int c, int chunk) {
  float s[VEC], t[VEC];
  const int r0 = blockIdx.x * chunk, r1 = min(rows, r0 + chunk);
  block_sums(s, t, part, c, [&](int lane, int lanes, int v) {
    for (int r = r0 + lane; r < r1; r += UNROLL * lanes) {
      Raw8<X> xv[UNROLL];
      bool m[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int row = r + u * lanes;
        m[u] = row < r1 && valid[row];
        if (m[u]) xv[u].load(x + (size_t)row * c + v * VEC);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!m[u]) continue;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xi = xv[u][i];
          s[i] += xi;
          t[i] += xi * xi;
        }
      }
    }
  });
}

// The plain formula's moments and running-statistics step for channel ch:
// n = max(n, 1); mean = s1/n; v0 = s2/n - mean^2; var = max(v0, 0);
// stats = [mean (c), inv (c), clamp passes (v0 >= 0: 1 or 0) (c), n].
__device__ __forceinline__ void finalize_channel(
    int ch, int c, float s1, float s2, float nf, float* stats, float* rmean,
    float* rvar, int update, float momentum, float keep, float eps) {
  const float n = fmaxf(nf, 1.0f);
  const float mean = __fdiv_rn(s1, n);
  const float v0 = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean, mean));
  const float var = v0 < 0.f ? 0.f : v0;
  stats[ch] = mean;
  stats[c + ch] = inv_std(var, eps);
  stats[2 * c + ch] = v0 >= 0.f ? 1.f : 0.f;
  if (ch == 0) stats[3 * c] = n;
  if (update) {
    const float unbiased =
        __fdiv_rn(__fmul_rn(var, n), fmaxf(__fsub_rn(n, 1.0f), 1.0f));
    rmean[ch] = __fadd_rn(__fmul_rn(rmean[ch], keep), __fmul_rn(momentum, mean));
    rvar[ch] = __fadd_rn(__fmul_rn(rvar[ch], keep), __fmul_rn(momentum, unbiased));
  }
}

// Sums the part rows in a fixed order: block b takes channels 16b..16b+15,
// lanes 0-15 their first column (s1 or Sg'), lanes 16-31 their second; warp
// w adds the parts w, w + 8, ..., then warp 0 adds the 8 warps in order.
// sums (optional) gets [first (c), second (c)] and, with n_valid, float(n)
// at 2c; with `finalize` each channel goes through finalize_channel.
__global__ void __launch_bounds__(THREADS)
bn_reduce_kernel(const float* __restrict__ part, int n_parts, int c,
                 const int* __restrict__ n_valid, float* __restrict__ sums,
                 float* __restrict__ stats, float* rmean, float* rvar,
                 int finalize, int update, float momentum, float keep,
                 float eps) {
  __shared__ float acc[THREADS / 32][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int ch = blockIdx.x * 16 + (lane & 15);
  const int col = (lane < 16 ? 0 : c) + ch;
  float s = 0.f;
  if (ch < c) {
#pragma unroll 4
    for (int p = w; p < n_parts; p += THREADS / 32)
      s += part[(size_t)p * 2 * c + col];
  }
  acc[w][lane] = s;
  __syncthreads();
  if (w != 0) return;
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) tot += acc[i][lane];
  const float second = __shfl_down_sync(0xffffffffu, tot, 16);
  if (ch >= c) return;
  if (sums) {
    sums[col] = tot;
    if (n_valid && blockIdx.x == 0 && lane == 0) sums[2 * c] = (float)*n_valid;
  }
  if (finalize && lane < 16)
    finalize_channel(ch, c, tot, second, (float)*n_valid, stats, rmean, rvar,
                     update, momentum, keep, eps);
}

// The group path's second half: the all-reduced sums [s1, s2, n] in.
__global__ void __launch_bounds__(THREADS)
bn_finalize_kernel(const float* __restrict__ sums, int c,
                   float* __restrict__ stats, float* rmean, float* rvar,
                   int update, float momentum, float keep, float eps) {
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  if (ch < c)
    finalize_channel(ch, c, sums[ch], sums[c + ch], sums[2 * c], stats, rmean,
                     rvar, update, momentum, keep, eps);
}

// Per-channel mean and inv into shared memory: inv from `istat` directly,
// or as inv_std of it when it holds the variance (eval).
__device__ __forceinline__ void channel_stats(const float* mean,
                                              const float* istat, int c,
                                              int from_var, float eps,
                                              float* s_mean, float* s_inv) {
  for (int ch = threadIdx.x; ch < c; ch += THREADS) {
    s_mean[ch] = mean[ch];
    s_inv[ch] = from_var ? inv_std(istat[ch], eps) : istat[ch];
  }
}

// Blocks of one wave of `kernel` at THREADS threads.
template <typename K>
int wave_of(K kernel) {
  int per_sm = 0, sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  return (per_sm > 0 ? per_sm : 1) * sms;
}

int elementwise_grid(long elems, int wave) {
  const long blocks = (elems + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  return (int)(blocks < wave ? (blocks > 0 ? blocks : 1) : wave);
}

// y over every row; the elements are the rows x c/8 vectors of 8 channels,
// walked by one wave of blocks, UNROLL a thread a block-width apart.
template <typename X, typename Y>
__global__ void __launch_bounds__(THREADS, 2)
bn_norm_kernel(const X* __restrict__ x, const Y* __restrict__ res,
               Y* __restrict__ y, const float* __restrict__ mean,
               const float* __restrict__ istat,
               const float* __restrict__ scale,
               const float* __restrict__ bias, int rows, int c, int relu,
               int from_var, float eps) {
  __shared__ float s_mean[MAXC], s_a[MAXC], s_b[MAXC];
  channel_stats(mean, istat, c, from_var, eps, s_mean, s_a);
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += THREADS) {
    s_a[ch] = __fmul_rn(s_a[ch], scale[ch]);
    s_b[ch] = bias[ch];
  }
  __syncthreads();
  const unsigned cv = c / VEC, total = (unsigned)rows * cv;
  for (unsigned e0 = blockIdx.x * THREADS * UNROLL + threadIdx.x; e0 < total;
       e0 += gridDim.x * THREADS * UNROLL) {
    Raw8<X> xv[UNROLL];
    Raw8<Y> rv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned e = e0 + u * THREADS;
      if (e >= total) continue;
      xv[u].load(x + (size_t)e * VEC);        // rows are c = cv * VEC apart
      if (res) rv[u].load(res + (size_t)e * VEC);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned e = e0 + u * THREADS;
      if (e >= total) continue;
      const int c0 = (e % cv) * VEC;
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int ch = c0 + i;
        float z = round_to(
            __fadd_rn(__fmul_rn(__fsub_rn(xv[u][i], s_mean[ch]), s_a[ch]),
                      s_b[ch]), y);
        if (res) z = round_to(__fadd_rn(z, rv[u][i]), y);
        o[i] = relu ? fmaxf(z, 0.f) : z;
      }
      store8(y + (size_t)e * VEC, o);
    }
  }
}

// g' = g, zeroed where y <= 0 under ReLU
template <typename Y>
__device__ __forceinline__ float masked_grad(const Raw8<Y>& g,
                                             const Raw8<Y>& y, int relu,
                                             int i) {
  return relu && !(y[i] > 0.f) ? 0.f : g[i];
}

// g rows are ldg elements apart (a slice of a concat's gradient).
template <typename X, typename Y>
__global__ void __launch_bounds__(THREADS, 2)
bn_bwd_sums_kernel(const Y* __restrict__ g, const Y* __restrict__ y,
                   const X* __restrict__ x, const float* __restrict__ mean,
                   const float* __restrict__ istat, float* __restrict__ part,
                   int rows, int c, int ldg, int relu, int from_var,
                   float eps, int chunk) {
  float s[VEC], t[VEC];
  const int r0 = blockIdx.x * chunk, r1 = min(rows, r0 + chunk);
  block_sums(s, t, part, c, [&](int lane, int lanes, int v) {
    float mu[VEC], inv[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mu[i] = mean[v * VEC + i];
      inv[i] = from_var ? inv_std(istat[v * VEC + i], eps) : istat[v * VEC + i];
    }
    for (int r = r0 + lane; r < r1; r += UNROLL * lanes) {
      Raw8<Y> gv[UNROLL], yv[UNROLL];
      Raw8<X> xv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int row = r + u * lanes;
        if (row >= r1) continue;
        gv[u].load(g + (size_t)row * ldg + v * VEC);
        if (relu) yv[u].load(y + (size_t)row * c + v * VEC);
        xv[u].load(x + (size_t)row * c + v * VEC);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u * lanes >= r1) continue;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float gp = masked_grad(gv[u], yv[u], relu, i);
          s[i] += gp;
          t[i] += gp * (__fsub_rn(xv[u][i], mu[i]) * inv[i]);
        }
      }
    }
  });
}

// dx = a g' - valid (k1 + xhat k2), k1 = a/n Sg', k2 = a/n Sg'xhat [clamp
// passes] (batch moments; eval: dx = a g'); dres = g' where asked.
template <typename X, typename Y>
__global__ void __launch_bounds__(THREADS, 2)
bn_dx_kernel(const Y* __restrict__ g, const Y* __restrict__ y,
             const X* __restrict__ x, const uint8_t* __restrict__ valid,
             const float* __restrict__ mean, const float* __restrict__ istat,
             const float* __restrict__ scale, const float* __restrict__ gsum,
             const float* __restrict__ ok, const float* __restrict__ n_p,
             X* __restrict__ dx, Y* __restrict__ dres, int rows, int c,
             int ldg, int relu, int from_var, float eps, int batch_stats) {
  __shared__ float s_mean[MAXC], s_inv[MAXC], s_a[MAXC], s_k1[MAXC],
      s_k2[MAXC];
  channel_stats(mean, istat, c, from_var, eps, s_mean, s_inv);
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += THREADS) {
    const float a = __fmul_rn(s_inv[ch], scale[ch]);
    s_a[ch] = a;
    if (batch_stats) {
      const float an = __fdiv_rn(a, *n_p);
      s_k1[ch] = __fmul_rn(an, gsum[ch]);
      s_k2[ch] = __fmul_rn(__fmul_rn(an, gsum[c + ch]), ok[ch]);
    }
  }
  __syncthreads();
  const unsigned cv = c / VEC, total = (unsigned)rows * cv;
  for (unsigned e0 = blockIdx.x * THREADS * UNROLL + threadIdx.x; e0 < total;
       e0 += gridDim.x * THREADS * UNROLL) {
    Raw8<Y> gv[UNROLL], yv[UNROLL];
    Raw8<X> xv[UNROLL];
    bool m[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned e = e0 + u * THREADS;
      if (e >= total) continue;
      const unsigned row = e / cv;
      gv[u].load(g + (size_t)row * ldg + (e % cv) * VEC);
      if (relu) yv[u].load(y + (size_t)e * VEC);
      xv[u].load(x + (size_t)e * VEC);
      m[u] = batch_stats && valid[row];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned e = e0 + u * THREADS;
      if (e >= total) continue;
      const unsigned c0 = (e % cv) * VEC;
      float d[VEC], gp[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int ch = c0 + i;
        gp[i] = masked_grad(gv[u], yv[u], relu, i);
        d[i] = __fmul_rn(gp[i], s_a[ch]);
        if (m[u]) {
          const float xh = __fmul_rn(__fsub_rn(xv[u][i], s_mean[ch]), s_inv[ch]);
          d[i] = __fsub_rn(d[i], __fadd_rn(s_k1[ch], __fmul_rn(xh, s_k2[ch])));
        }
      }
      store8(dx + (size_t)e * VEC, d);
      if (dres) store8(dres + (size_t)e * VEC, gp);
    }
  }
}

int rc() { return static_cast<int>(cudaGetLastError()); }

template <typename X>
int launch_sums(const void* x, const void* valid, void* part, int rows, int c,
                int n_parts, cudaStream_t s) {
  const int chunk = (rows + n_parts - 1) / n_parts;
  bn_sums_kernel<X><<<n_parts, THREADS, 0, s>>>(
      static_cast<const X*>(x), static_cast<const uint8_t*>(valid),
      static_cast<float*>(part), rows, c, chunk);
  return rc();
}

template <typename X, typename Y>
int launch_norm(const void* x, const void* res, void* y, const void* mean,
                const void* istat, const void* scale, const void* bias,
                int rows, int c, int relu, int from_var, float eps,
                cudaStream_t s) {
  constexpr auto kernel = bn_norm_kernel<X, Y>;
  static int wave = 0;              // blocks of one wave, read once
  if (!wave) wave = wave_of(kernel);
  kernel<<<elementwise_grid((long)rows * (c / VEC), wave), THREADS, 0, s>>>(
      static_cast<const X*>(x), static_cast<const Y*>(res),
      static_cast<Y*>(y), static_cast<const float*>(mean),
      static_cast<const float*>(istat), static_cast<const float*>(scale),
      static_cast<const float*>(bias), rows, c, relu, from_var, eps);
  return rc();
}

template <typename X, typename Y>
int launch_bwd_sums(const void* g, const void* y, const void* x,
                    const void* mean, const void* istat, void* part, int rows,
                    int c, int ldg, int relu, int from_var, float eps,
                    int n_parts, cudaStream_t s) {
  const int chunk = (rows + n_parts - 1) / n_parts;
  bn_bwd_sums_kernel<X, Y><<<n_parts, THREADS, 0, s>>>(
      static_cast<const Y*>(g), static_cast<const Y*>(y),
      static_cast<const X*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(istat), static_cast<float*>(part), rows, c,
      ldg, relu, from_var, eps, chunk);
  return rc();
}

template <typename X, typename Y>
int launch_dx(const void* g, const void* y, const void* x, const void* valid,
              const void* mean, const void* istat, const void* scale,
              const void* gsum, const void* ok, const void* n, void* dx,
              void* dres, int rows, int c, int ldg, int relu, int from_var,
              float eps, int batch_stats, cudaStream_t s) {
  constexpr auto kernel = bn_dx_kernel<X, Y>;
  static int wave = 0;
  if (!wave) wave = wave_of(kernel);
  kernel<<<elementwise_grid((long)rows * (c / VEC), wave), THREADS, 0, s>>>(
      static_cast<const Y*>(g), static_cast<const Y*>(y),
      static_cast<const X*>(x), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(mean), static_cast<const float*>(istat),
      static_cast<const float*>(scale), static_cast<const float*>(gsum),
      static_cast<const float*>(ok), static_cast<const float*>(n),
      static_cast<X*>(dx), static_cast<Y*>(dres), rows, c, ldg, relu,
      from_var, eps, batch_stats);
  return rc();
}

bool bad_shape(int rows, int c) {
  return rows < 0 || c < VEC || c % VEC || c > MAXC ||
         (long)rows * (c / VEC) >= (1L << 31);
}

using BF = __nv_bfloat16;

}  // namespace

extern "C" {

// x (rows, c) f32 or bf16 (x_bf16), c % 8 == 0, c <= 1024, 16-byte aligned;
// valid (rows,) u8; part (n_parts, 2c) f32: each block's [s1, s2] over
// its chunk of ceil(rows / n_parts) rows.
int b2m_bn_sums(const void* x, const void* valid, void* part, int rows, int c,
                int x_bf16, int n_parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(rows, c) || n_parts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return x_bf16 ? launch_sums<BF>(x, valid, part, rows, c, n_parts, s)
                : launch_sums<float>(x, valid, part, rows, c, n_parts, s);
}

// part (n_parts, 2c) -> sums (2c [+1: float(*n_valid) when n_valid]),
// optional; with `finalize`, stats (3c + 1) = [mean, inv, clamp passes, n]
// from the sums and n_valid, and with `update` the running mean / var
// (c each) moved in place: r = r * keep + momentum * value.
int b2m_bn_reduce(const void* part, int n_parts, int c, const void* n_valid,
                  void* sums, void* stats, void* rmean, void* rvar,
                  int finalize, int update, float momentum, float keep,
                  float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c < 1 || n_parts < 1 || (finalize && (!n_valid || !stats)))
    return static_cast<int>(cudaErrorInvalidValue);
  bn_reduce_kernel<<<(c + 15) / 16, THREADS, 0, s>>>(
      static_cast<const float*>(part), n_parts, c,
      static_cast<const int*>(n_valid), static_cast<float*>(sums),
      static_cast<float*>(stats), static_cast<float*>(rmean),
      static_cast<float*>(rvar), finalize, update, momentum, keep, eps);
  return rc();
}

// sums (2c + 1) = [s1, s2, n], all-reduced over a group -> stats as above.
int b2m_bn_finalize(const void* sums, int c, void* stats, void* rmean,
                    void* rvar, int update, float momentum, float keep,
                    float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  bn_finalize_kernel<<<(c + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float*>(sums), c, static_cast<float*>(stats),
      static_cast<float*>(rmean), static_cast<float*>(rvar), update, momentum,
      keep, eps);
  return rc();
}

// y (rows, c) f32 or bf16 (y_bf16) from x and, when res is not null, the
// residual res (y's dtype); mean and istat (c) f32: istat is inv, or the
// variance when from_var; scale, bias (c) f32.
int b2m_bn_norm(const void* x, const void* res, void* y, const void* mean,
                const void* istat, const void* scale, const void* bias,
                int rows, int c, int x_bf16, int y_bf16, int relu,
                int from_var, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(rows, c)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  if (x_bf16 && y_bf16)
    return launch_norm<BF, BF>(x, res, y, mean, istat, scale, bias, rows, c, relu, from_var, eps, s);
  if (x_bf16)
    return launch_norm<BF, float>(x, res, y, mean, istat, scale, bias, rows, c, relu, from_var, eps, s);
  if (y_bf16)
    return launch_norm<float, BF>(x, res, y, mean, istat, scale, bias, rows, c, relu, from_var, eps, s);
  return launch_norm<float, float>(x, res, y, mean, istat, scale, bias, rows, c, relu, from_var, eps, s);
}

// g (rows, c) in y's dtype, rows ldg elements apart (ldg % 8 == 0); y (the
// forward's output, read only under relu); x; mean, istat as b2m_bn_norm;
// part (n_parts, 2c) f32: each block's [Sg', Sg'xhat] over its chunk.
int b2m_bn_bwd_sums(const void* g, const void* y, const void* x,
                    const void* mean, const void* istat, void* part, int rows,
                    int c, int ldg, int x_bf16, int y_bf16, int relu,
                    int from_var, float eps, int n_parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(rows, c) || n_parts < 1 || ldg < c || ldg % VEC ||
      (relu && !y))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16 && y_bf16)
    return launch_bwd_sums<BF, BF>(g, y, x, mean, istat, part, rows, c, ldg, relu, from_var, eps, n_parts, s);
  if (x_bf16)
    return launch_bwd_sums<BF, float>(g, y, x, mean, istat, part, rows, c, ldg, relu, from_var, eps, n_parts, s);
  if (y_bf16)
    return launch_bwd_sums<float, BF>(g, y, x, mean, istat, part, rows, c, ldg, relu, from_var, eps, n_parts, s);
  return launch_bwd_sums<float, float>(g, y, x, mean, istat, part, rows, c, ldg, relu, from_var, eps, n_parts, s);
}

// dx (rows, c) in x's dtype and, when dres is not null, dres = g' in y's;
// gsum (2c) = [Sg', Sg'xhat] over every row of every rank, ok (c) the clamp
// flags and n_p (1) the count of stats (read only when batch_stats).
int b2m_bn_dx(const void* g, const void* y, const void* x, const void* valid,
              const void* mean, const void* istat, const void* scale,
              const void* gsum, const void* ok, const void* n_p, void* dx,
              void* dres, int rows, int c, int ldg, int x_bf16, int y_bf16,
              int relu, int from_var, float eps, int batch_stats,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(rows, c) || ldg < c || ldg % VEC || (relu && !y) ||
      (batch_stats && (!valid || !gsum || !ok || !n_p)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  if (x_bf16 && y_bf16)
    return launch_dx<BF, BF>(g, y, x, valid, mean, istat, scale, gsum, ok, n_p, dx, dres, rows, c, ldg, relu, from_var, eps, batch_stats, s);
  if (x_bf16)
    return launch_dx<BF, float>(g, y, x, valid, mean, istat, scale, gsum, ok, n_p, dx, dres, rows, c, ldg, relu, from_var, eps, batch_stats, s);
  if (y_bf16)
    return launch_dx<float, BF>(g, y, x, valid, mean, istat, scale, gsum, ok, n_p, dx, dres, rows, c, ldg, relu, from_var, eps, batch_stats, s);
  return launch_dx<float, float>(g, y, x, valid, mean, istat, scale, gsum, ok, n_p, dx, dres, rows, c, ldg, relu, from_var, eps, batch_stats, s);
}

}  // extern "C"
