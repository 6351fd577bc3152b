// The output tile of the gather-GEMM sparse convolutions, shared by
// csrc/key_conv.cu (rows matched by a key search) and csrc/nmap_conv.cu
// (rows read from a neighbor map):
//
//   out[v] = sum_k bf16(x[src_k(v)]) @ bf16(w[k])      (f32 accumulation)
//
// for the TILE_M = 64 output rows and NT output channels of one block, where
// src_k(v) is the input row matched at offset k, or -1 (adds 0). Per offset
// threads 0..63 each produce their row's match; a block vote skips an
// offset that no row of the tile matched. The matched bf16 rows are gathered
// into shared memory (0 for a miss), the w[k] slice beside them, and four
// warps multiply them on the tensor cores (wmma 16x16x16, bf16 in, f32
// accumulators in registers), KC input channels at a time. The epilogue
// writes each row once, as f32 or rounded to bf16.

#pragma once

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace conv_tile {

using namespace nvcuda;

constexpr int TILE_M = 64;
constexpr int THREADS = 128;   // 4 warps x 16 output rows

__device__ __forceinline__ float to_out(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// TILE_M gathered rows of x, channels c0 .. c0 + KC, into xs (row stride
// LDX) as bf16; 0 for a row whose src is -1 and for channels >= cin. NTHR:
// the block's thread count.
template <int KC, int LDX, int NTHR = THREADS>
__device__ __forceinline__ void gather_tile(const __nv_bfloat16* __restrict__ x,
                                            const int* src, int cin, int c0,
                                            __nv_bfloat16* xs) {
  constexpr int XV = KC / 8;      // 16-byte vectors per gathered row chunk
  const bool vec_x = (cin % 8) == 0;
  for (int i = threadIdx.x; i < TILE_M * XV; i += NTHR) {
    const int r = i / XV, v = i % XV, c = c0 + v * 8, s = src[r];
    union { uint4 u; unsigned short h[8]; } val;   // 8 bf16 bit patterns
    val.u = make_uint4(0, 0, 0, 0);
    if (s >= 0) {
      const __nv_bfloat16* p = x + (size_t)s * cin + c;
      if (vec_x) {
        if (c < cin) val.u = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        const unsigned short* ph = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (c + e < cin) val.h[e] = ph[e];
      }
    }
    *reinterpret_cast<uint4*>(xs + r * LDX + v * 8) = val.u;
  }
}

// The block's tile of out. `match(k)` is called by threads 0 .. TILE_M - 1
// only, once per offset, and returns the input row of output row
// blockIdx.x * TILE_M + threadIdx.x at offset k, or -1 (rows past n_out
// return -1). Output channels blockIdx.y * NT .. + NT; cout % 8 == 0.
template <int NT, int KC, typename OutT, typename Match>
__device__ __forceinline__ void conv_tile(const __nv_bfloat16* __restrict__ x,
                                          const __nv_bfloat16* __restrict__ w,
                                          OutT* __restrict__ out, int n_out,
                                          int cin, int cout, int K,
                                          const Match& match) {
  constexpr int NF = NT / 16;     // accumulator fragments per warp
  constexpr int LDX = KC + 8;     // padded smem strides (16-byte multiples)
  constexpr int LDW = NT + 8;
  constexpr int WV = NT / 8;
  __shared__ __align__(32) __nv_bfloat16 xs[TILE_M * LDX];
  __shared__ __align__(32) __nv_bfloat16 ws[KC * LDW];
  __shared__ __align__(32) float stage[THREADS / 32][16 * 16];
  __shared__ int src[TILE_M];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * TILE_M;
  const int n0 = blockIdx.y * NT;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int k = 0; k < K; ++k) {
    const int hit = tid < TILE_M ? match(k) : -1;
    __syncthreads();                  // last offset's readers of smem done
    if (tid < TILE_M) src[tid] = hit;
    if (!__syncthreads_or(hit >= 0)) continue;

    for (int c0 = 0; c0 < cin; c0 += KC) {
      if (c0 > 0) __syncthreads();
      gather_tile<KC, LDX>(x, src, cin, c0, xs);
      const __nv_bfloat16* wk = w + (size_t)k * cin * cout + n0;
      for (int i = tid; i < KC * WV; i += THREADS) {
        const int r = i / WV, v = i % WV, c = c0 + r;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (c < cin)
          val = __ldg(reinterpret_cast<const uint4*>(wk + (size_t)c * cout +
                                                     v * 8));
        *reinterpret_cast<uint4*>(ws + r * LDW + v * 8) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + warp * 16 * LDX + kk, LDX);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(bf, ws + kk * LDW + j * 16, LDW);
          wmma::mma_sync(acc[j], a, bf, acc[j]);
        }
      }
    }
  }

  // epilogue: each warp stages one 16x16 fragment at a time and writes it
  // out in the output dtype (f32, or bf16 rounded to nearest even)
  float* st = stage[warp];
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = row0 + warp * 16 + e / 16;
      if (r < n_out)
        out[(size_t)r * cout + n0 + j * 16 + e % 16] =
            to_out(st[e], (OutT*)nullptr);
    }
    __syncwarp();
  }
}

}  // namespace conv_tile
