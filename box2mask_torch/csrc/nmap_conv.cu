// Neighbor-map sparse convolution and monotone row gather for Hopper
// (sm_90a), bound through a plain C interface (ctypes;
// box2mask_torch/sparse/_build.py builds this file).
//
// Replaces the two Pallas TPU kernels of box2mask_tpu/sparse/pallas_conv.py:
//   * _kernel (:36, via sparse_conv :114 / _pallas_forward :80):
//       out[v] = sum_k bf16(x[nbr[v, k]]) @ bf16(w[k])   (f32 accumulation)
//     with nbr (Vout, K) int32 and the sentinel nbr >= Vin adding 0; K = 125
//     (the 5^3 stem, cin 6), 27 (3^3 same level) or 8 (2^3 down); f32 out;
//   * _gather_kernel (:148, via gather_rows :175):
//       out[i] = f32(bf16(x[idx[i]])), 0 where idx >= Vin,
//     the transpose up conv's pick of one of the 8 weight slots per fine row
//     from the f32 product of the coarse rows with all 8 slots.
//
// Conv design: the tile of csrc/conv_tile.cuh, as in the key-matching conv
// of csrc/key_conv.cu: one block owns 128 output rows x NT output channels;
// its matches are one coalesced read of the tile's K map entries per row
// (entries >= vin become -1), then the live-offset list, the cp.async /
// bulk-copy ring (zeros at the sentinel and past cin: the stem's cin 6,
// zero-padded to 8 by the wrapper, pads to 16), wgmma with f32 accumulators in registers and 16-byte f32 stores.
// A padding row (all sentinels) comes out exactly 0. The TPU kernel's union
// window DMA, one-hot MXU gather, 128-lane channel padding and TILE 256 /
// WINDOW 2048 have no part here.
//
// Bound on the H100: at the main path's shapes the FLOPs of the matched
// pairs (2 * hits * cin * cout) are far under the 989 TFLOP/s bf16 peak, so
// the bound is the bytes over 3.35 TB/s: the valid x rows and w in bf16, the
// int32 map (Vout * K * 4 B, 57 MB for the level-0 3^3 map of 4 ScanNet
// scenes) and the f32 output.
//
// Gather design. Bytes-bound: idx read once, each gathered row read once,
// the output written once. The output is walked as one flat array of
// 16-byte elements (4 channels; single floats where c % 4 != 0 or x is
// unaligned) by one wave of persistent blocks. Each thread takes 4
// elements a block-width apart, issues their idx loads, then their x loads,
// then its stores, so that 8 loads are in flight per thread; neighbouring
// threads touch neighbouring addresses of a row, and the rounding f32 ->
// bf16 (nearest even) -> f32 is done in pairs in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv_tile.cuh"

namespace {

// The tile's matches from the neighbor map: the M x K entries of its rows
// are one contiguous, coalesced read.
struct MapMatches {
  const int* __restrict__ nbr;
  int row0, n_out, vin, K;

  __device__ __forceinline__ void operator()(int* mt, int*) const {
    using conv_tile::M;
    const int rows = min(M, n_out - row0);
    for (int i = threadIdx.x; i < M * K; i += conv_tile::THREADS) {
      const int r = i / K, k = i % K;
      const int v = r < rows ? __ldg(nbr + (size_t)row0 * K + i) : -1;
      mt[k * conv_tile::MS + r] =
          static_cast<unsigned>(v) < static_cast<unsigned>(vin) ? v : -1;
    }
  }
};

template <int NT>
__global__ void __launch_bounds__(conv_tile::THREADS)
nmap_conv_kernel(const __nv_bfloat16* __restrict__ x,
                 const int* __restrict__ nbr,
                 const __nv_bfloat16* __restrict__ wp,
                 float* __restrict__ out, int n_out, int vin, int K, int cin,
                 int cout, int stages, int ips) {
  const MapMatches m{nbr, (int)blockIdx.x * conv_tile::M, n_out, vin, K};
  conv_tile::conv_tile<NT>(x, wp, out, n_out, cin, cout, K, stages, ips, m);
}

template <int NT>
int launch_conv(const void* x, const void* nbr, const void* w, void* wp,
                void* out, int n_out, int vin, int K, int cin, int cout,
                cudaStream_t stream) {
  int rc = conv_tile::pack_w(w, wp, K, cin, cout, NT, stream);
  if (rc) return rc;
  return conv_tile::launch_tile<NT, nmap_conv_kernel<NT>>(
      n_out, cin, cout, K, stream,
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(nbr),
      static_cast<const __nv_bfloat16*>(wp), static_cast<float*>(out), n_out,
      vin, K, cin, cout);
}

int dispatch_conv(const void* x, const void* nbr, const void* w, void* wp,
                  void* out, int n_out, int vin, int K, int cin, int cout,
                  cudaStream_t s) {
  if (cout % 128 == 0) return launch_conv<128>(x, nbr, w, wp, out, n_out, vin, K, cin, cout, s);
  if (cout % 96 == 0) return launch_conv<96>(x, nbr, w, wp, out, n_out, vin, K, cin, cout, s);
  if (cout % 64 == 0) return launch_conv<64>(x, nbr, w, wp, out, n_out, vin, K, cin, cout, s);
  if (cout % 32 == 0) return launch_conv<32>(x, nbr, w, wp, out, n_out, vin, K, cin, cout, s);
  if (cout % 16 == 0) return launch_conv<16>(x, nbr, w, wp, out, n_out, vin, K, cin, cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float4 round_bf16(float4 v) {
  const float2 a = __bfloat1622float2(__float22bfloat162_rn(make_float2(v.x, v.y)));
  const float2 b = __bfloat1622float2(__float22bfloat162_rn(make_float2(v.z, v.w)));
  return make_float4(a.x, a.y, b.x, b.y);
}

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_U = 4;        // elements in flight per thread

// out viewed as n * w elements (w = c / 4 float4 per row when VEC: c % 4 ==
// 0 and x 16-byte aligned; else w = c floats). Persistent blocks walk it in
// chunks of GATHER_THREADS * GATHER_U; each thread loads the idx of its U
// elements, then their x values, then stores them rounded to bf16 and back.
template <bool VEC>
__global__ void __launch_bounds__(GATHER_THREADS)
gather_rows_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   float* __restrict__ out, int n, int vin, int c) {
  using T = typename std::conditional<VEC, float4, float>::type;
  const unsigned w = VEC ? c / 4 : c;
  const unsigned total = (unsigned)n * w;
  const T* xs = reinterpret_cast<const T*>(x);
  T* os = reinterpret_cast<T*>(out);
  for (unsigned e0 = blockIdx.x * GATHER_THREADS * GATHER_U + threadIdx.x;
       e0 < total; e0 += gridDim.x * GATHER_THREADS * GATHER_U) {
    int v[GATHER_U];
#pragma unroll
    for (int u = 0; u < GATHER_U; ++u) {
      const unsigned e = e0 + u * GATHER_THREADS;
      v[u] = e < total ? __ldg(idx + e / w) : -1;
    }
    T val[GATHER_U];
#pragma unroll
    for (int u = 0; u < GATHER_U; ++u) {
      const unsigned e = e0 + u * GATHER_THREADS;
      val[u] = T{};
      if (static_cast<unsigned>(v[u]) < static_cast<unsigned>(vin))
        val[u] = __ldg(xs + (size_t)v[u] * w + e % w);
    }
#pragma unroll
    for (int u = 0; u < GATHER_U; ++u) {
      const unsigned e = e0 + u * GATHER_THREADS;
      if (e < total) os[e] = round_bf16(val[u]);
    }
  }
}

template <bool VEC>
int launch_gather(const void* x, const void* idx, void* out, int n, int vin,
                  int c, cudaStream_t stream) {
  constexpr auto kernel = gather_rows_kernel<VEC>;
  static int wave = 0;              // blocks of one wave, read once
  if (!wave) {
    int per_sm = 0, sms = 132, dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  GATHER_THREADS, 0);
    wave = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const long total = (long)n * (VEC ? c / 4 : c);
  const long chunks = (total + GATHER_THREADS * GATHER_U - 1) /
                      (GATHER_THREADS * GATHER_U);
  const int grid = (int)(chunks < wave ? chunks : wave);
  kernel<<<grid, GATHER_THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), n, vin, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (vin, cin) bf16; nbr (n_out, K) i32, entries >= vin add 0; w (K, cin,
// cout) bf16 with cin % 8 == 0 (x and w zero-padded by the caller) and
// cout % 16 == 0; wp scratch of K * cout * n_ch * kc bf16
// (conv_tile::chunks), the packed w; out (n_out, cout) f32. Returns the CUDA
// error code of the launches.
int b2m_nmap_conv(const void* x, const void* nbr, const void* w, void* wp,
                  void* out, int n_out, int vin, int K, int cin, int cout,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || cin % 8 || K < 1 || cout % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0 || cout == 0) return 0;
  return dispatch_conv(x, nbr, w, wp, out, n_out, vin, K, cin, cout, s);
}

// x (vin, c) f32; idx (n,) i32, entries >= vin give 0; out (n, c) f32;
// n * c < 2^31.
int b2m_gather_rows(const void* x, const void* idx, void* out, int n,
                    int vin, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0 || c == 0) return 0;
  if (n < 0 || c < 0 || (long)n * c >= (1L << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0)
    return launch_gather<true>(x, idx, out, n, vin, c, s);
  return launch_gather<false>(x, idx, out, n, vin, c, s);
}

}  // extern "C"
