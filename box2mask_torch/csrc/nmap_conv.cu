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
// Conv design. The tile of csrc/conv_tile.cuh, as in the key-matching conv
// of csrc/key_conv.cu: one block owns 64 output rows x NT output channels;
// per offset each of threads 0..63 reads its row's map entry, a block vote
// skips an offset that no row of the tile matched, the matched bf16 rows and
// w[k] are staged in shared memory (zeros at the sentinel, and past cin: the
// stem's cin 6 is padded to one 16-wide chunk) and four warps multiply them
// on the tensor cores (wmma, f32 accumulators in registers). The output is
// written once; a padding row (all sentinels) comes out exactly 0. The TPU
// kernel's union window DMA, one-hot MXU gather, 128-lane channel padding
// and TILE 256 / WINDOW 2048 have no part here.
//
// Bound on the H100: at the main path's shapes the FLOPs of the matched
// pairs (2 * hits * cin * cout) are far under the 989 TFLOP/s bf16 peak, so
// the bound is the bytes over 3.35 TB/s: the valid x rows and w in bf16, the
// int32 map (Vout * K * 4 B, 57 MB for the level-0 3^3 map of 4 ScanNet
// scenes) and the f32 output. A row's map entries are K * 4 bytes apart, so
// the first offset brings the tile's map rows into L1 and the later offsets
// read them from there; the per-offset chain of map load, gather and
// products is not pipelined (work for a later version, with the key conv's).
//
// Gather design. One warp per output row, grid-striding: lane j moves
// channels 4j .. 4j + 3 with one 16-byte load and store, rounding each value
// f32 -> bf16 (nearest even) -> f32 in registers. Bytes-bound: idx read
// once, each gathered row read once, the output written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace {

using conv_tile::TILE_M;
using conv_tile::THREADS;

template <int NT, int KC>
__global__ void __launch_bounds__(THREADS)
nmap_conv_kernel(const __nv_bfloat16* __restrict__ x,
                 const int* __restrict__ nbr,
                 const __nv_bfloat16* __restrict__ w,
                 float* __restrict__ out, int n_out, int vin, int K, int cin,
                 int cout) {
  const int row = blockIdx.x * TILE_M + threadIdx.x;
  const int* nrow = (threadIdx.x < TILE_M && row < n_out)
                        ? nbr + (size_t)row * K : nullptr;
  conv_tile::conv_tile<NT, KC>(x, w, out, n_out, cin, cout, K, [&](int k) {
    if (nrow == nullptr) return -1;
    const int v = __ldg(nrow + k);
    return static_cast<unsigned>(v) < static_cast<unsigned>(vin) ? v : -1;
  });
}

template <int NT, int KC>
void launch_conv(const void* x, const void* nbr, const void* w, void* out,
                 int n_out, int vin, int K, int cin, int cout,
                 cudaStream_t stream) {
  dim3 grid((n_out + TILE_M - 1) / TILE_M, cout / NT);
  nmap_conv_kernel<NT, KC><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(nbr),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), n_out,
      vin, K, cin, cout);
}

template <int KC>
int dispatch_conv(const void* x, const void* nbr, const void* w, void* out,
                  int n_out, int vin, int K, int cin, int cout,
                  cudaStream_t s) {
  if (cout % 128 == 0) launch_conv<128, KC>(x, nbr, w, out, n_out, vin, K, cin, cout, s);
  else if (cout % 96 == 0) launch_conv<96, KC>(x, nbr, w, out, n_out, vin, K, cin, cout, s);
  else if (cout % 64 == 0) launch_conv<64, KC>(x, nbr, w, out, n_out, vin, K, cin, cout, s);
  else if (cout % 32 == 0) launch_conv<32, KC>(x, nbr, w, out, n_out, vin, K, cin, cout, s);
  else if (cout % 16 == 0) launch_conv<16, KC>(x, nbr, w, out, n_out, vin, K, cin, cout, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// VEC: c % 4 == 0 and 16-byte aligned rows (one float4 per lane and step).
template <bool VEC>
__global__ void __launch_bounds__(256)
gather_rows_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   float* __restrict__ out, int n, int vin, int c) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < n;
       r += gridDim.x * warps) {
    const int v = __ldg(idx + r);
    const bool ok = static_cast<unsigned>(v) < static_cast<unsigned>(vin);
    if (VEC) {
      const float4* src =
          reinterpret_cast<const float4*>(x + (size_t)(ok ? v : 0) * c);
      float4* dst = reinterpret_cast<float4*>(out + (size_t)r * c);
      for (int j = lane; j < c / 4; j += 32) {
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) {
          val = __ldg(src + j);
          val.x = round_bf16(val.x);
          val.y = round_bf16(val.y);
          val.z = round_bf16(val.z);
          val.w = round_bf16(val.w);
        }
        dst[j] = val;
      }
    } else {
      for (int j = lane; j < c; j += 32)
        out[(size_t)r * c + j] =
            ok ? round_bf16(__ldg(x + (size_t)v * c + j)) : 0.0f;
    }
  }
}

}  // namespace

extern "C" {

// x (vin, cin) bf16; nbr (n_out, K) i32, entries >= vin add 0; w (K, cin,
// cout) bf16 with cout % 16 == 0; out (n_out, cout) f32. Returns the
// cudaGetLastError() after launch.
int b2m_nmap_conv(const void* x, const void* nbr, const void* w, void* out,
                  int n_out, int vin, int K, int cin, int cout,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || K < 1 || cout % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0 || cout == 0) return 0;
  if (cin <= 16)
    return dispatch_conv<16>(x, nbr, w, out, n_out, vin, K, cin, cout, s);
  return dispatch_conv<32>(x, nbr, w, out, n_out, vin, K, cin, cout, s);
}

// x (vin, c) f32; idx (n,) i32, entries >= vin give 0; out (n, c) f32.
int b2m_gather_rows(const void* x, const void* idx, void* out, int n,
                    int vin, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0 || c == 0) return 0;
  const int warps = 8;
  const long blocks = ((long)n + warps - 1) / warps;
  const int grid = (int)(blocks < 132 * 64 ? blocks : 132 * 64);
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    gather_rows_kernel<true><<<grid, warps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(idx),
        static_cast<float*>(out), n, vin, c);
  else
    gather_rows_kernel<false><<<grid, warps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(idx),
        static_cast<float*>(out), n, vin, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
