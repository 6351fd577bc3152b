// Packed-key sparse convolution for Hopper (sm_90a), bound through a plain C
// interface (ctypes; box2mask_torch/sparse/_build.py builds this file).
//
// Replaces the four Pallas TPU kernels of box2mask_tpu/sparse/key_conv.py:
//   * _kernel (:116, via key_conv :277): 3^3 same-level conv (guarded),
//     2^3 stride-2 down conv (stride_child), transpose up conv (stride_parent);
//   * _stem_kernel (:542, via key_conv_stem :637): the 5^3 stem, cin <= 8,
//     always f32 out;
//   * _dw_kernel (:814, via key_conv_dw :934): the weight gradient of the
//     three _kernel modes;
//   * _stem_dw_kernel (:557, via key_conv_stem_dw :678): the stem's weight
//     gradient.
// The forward kernels compute
//   out[v] = sum_k bf16(x[match(key_out[v] + sign * delta_k * scale)]) @ bf16(w[k])
// and the weight-gradient kernels
//   dw[k] = sum_v bf16(x[match(key_out[v] + sign * delta_k * scale)])^T bf16(g[v])
// accumulated in f32, where match() finds the key in scene b = v / pad_out's
// own sorted key row keys_in[b, :]; a missing neighbour, a guarded axis wrap
// or a SENT output key contributes 0.
//
// Forward design. One block owns TILE_M = 64 output rows and NT output
// channels. For each kernel offset, threads 0..63 build their row's query and
// binary-search the scene's sorted key row (a ScanNet-scale row is 512 KB and
// stays in the 50 MB L2); a block vote skips offsets no row of the tile
// matched (the GPU form of the TPU kernel's count == 0 skip, :167-170). The
// matched bf16 rows are gathered into shared memory (0 for a miss) together
// with the w[k] slice, and four warps multiply them on the tensor cores (wmma
// 16x16x16, bf16 in, f32 accumulate in registers). The TPU's one-hot gather
// matmul, 128-lane windows, host window plans and DMA double buffering have
// no part here: the search replaces the window plans.
//
// Weight-gradient design. The TPU kernel carries one (K, cin, cout) sum
// through its sequential grid; here blocks run in parallel. Pass 0 searches
// every (offset, output row) pair at once into an int32 match table, so a
// tile's matches are one coalesced load and not a chain of dependent
// searches. Pass 1: a block owns one offset k, a CI x NT slab of dw[k]
// (CI = 64 input channels up to cin 64, else 128) and a fixed slice of the
// row tiles (tiles s, s + S, s + 2S, ...); per tile it gathers the matched x
// rows and the tile's g rows (both bf16, zero where the row matched nothing)
// and accumulates x^T g on the tensor cores in registers, then writes its
// slab to partials[s]. Pass 2 adds the S partials in slice order. No atomics:
// the result is the same bit for bit from run to run. The stem's dw (K = 125,
// cin <= 8, cout <= 32) keeps a block's whole (25 offsets, cin, cout) share
// of dw in shared memory instead, so each g tile is loaded once per 25
// offsets rather than once per offset, and feeds the same pass 2.
//
// Bound on the H100: at the main path's shapes the work is small
// (2 * hits * cin * cout FLOPs, far under the 989 TFLOP/s bf16 peak), so the
// bound is the bytes (x and g read once, out or dw written once, keys and w)
// over 3.35 TB/s. The forward spends its time on the dependent L2 loads of
// the per-row binary search (~17 per offset at pad 131072); the dw kernel,
// with its searches moved to the table, on the per-tile chain of table load,
// gather and products, and on re-reading each g tile once per offset.
// wgmma, TMA, software pipelining and one table shared by a level's forward,
// dx and dw launches are work for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kSentKey = 1 << 30;
constexpr int kAxisBits = 10;
constexpr int kAxisMax = 1 << kAxisBits;
constexpr int TILE_M = 64;
constexpr int THREADS = 128;   // 4 warps x 16 output rows

struct Geom {
  int B, pad_in, pad_out, cin, cout;
  int ks;      // offsets per axis (3 or 5 same-level, 2 strided)
  int lo;      // first offset per axis (-ks/2, or 0 for the strided sets)
  int sign;    // +1, or -1 for the transpose (stride_parent) conv
  int scale;   // 2^level
  int guard;   // mask axis wraps of the unpacked fields
};

__device__ __forceinline__ float to_out(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// first position p in keys[0, n) with keys[p] >= q
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys, int n,
                                           int q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Row of keys_in matched by output key `key` of scene b at offset k (x-major
// over ks^3, fields lo.. lo+ks-1 times scale), or -1. Packed deltas are
// arithmetic sums (negative fields borrow); the transpose conv's queries go
// negative at scene borders and match nothing.
__device__ __forceinline__ int match(const Geom& g,
                                     const int* __restrict__ keys_in, int key,
                                     int b, int k) {
  if (key >= kSentKey) return -1;
  const int sx = (k / (g.ks * g.ks) + g.lo) * g.scale;
  const int sy = ((k / g.ks) % g.ks + g.lo) * g.scale;
  const int sz = (k % g.ks + g.lo) * g.scale;
  if (g.guard) {
    const int xf = key >> (2 * kAxisBits);
    const int yf = (key >> kAxisBits) & (kAxisMax - 1);
    const int zf = key & (kAxisMax - 1);
    if (xf + sx < 0 || xf + sx >= kAxisMax || yf + sy < 0 ||
        yf + sy >= kAxisMax || zf + sz < 0 || zf + sz >= kAxisMax)
      return -1;
  }
  const int q = key + g.sign * (sx * (1 << (2 * kAxisBits)) +
                                sy * (1 << kAxisBits) + sz);
  if (q < 0) return -1;
  const int* krow = keys_in + (size_t)b * g.pad_in;
  const int p = lower_bound(krow, g.pad_in, q);
  return (p < g.pad_in && __ldg(krow + p) == q) ? b * g.pad_in + p : -1;
}

// TILE_M gathered rows of x, channels c0 .. c0 + KC, into xs (row stride
// LDX) as bf16; 0 for a row whose src is -1 and for channels >= cin. NTHR:
// the block's thread count.
template <int KC, int LDX, int NTHR = THREADS>
__device__ __forceinline__ void gather_rows(const __nv_bfloat16* __restrict__ x,
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

template <int NT, int KC, typename OutT>
__global__ void __launch_bounds__(THREADS)
key_conv_kernel(const __nv_bfloat16* __restrict__ x,
                const int* __restrict__ keys_in,
                const int* __restrict__ keys_out,
                const __nv_bfloat16* __restrict__ w,
                OutT* __restrict__ out, Geom g) {
  constexpr int NF = NT / 16;     // accumulator fragments per warp
  constexpr int LDX = KC + 8;     // padded smem strides (16-byte multiples)
  constexpr int LDW = NT + 8;
  constexpr int WV = NT / 8;
  __shared__ __align__(32) __nv_bfloat16 xs[TILE_M * LDX];
  __shared__ __align__(32) __nv_bfloat16 ws[KC * LDW];
  __shared__ __align__(32) float stage[THREADS / 32][16 * 16];
  __shared__ int src[TILE_M];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_out = g.B * g.pad_out;
  const int row0 = blockIdx.x * TILE_M;
  const int n0 = blockIdx.y * NT;

  int key = kSentKey, b = 0;
  if (tid < TILE_M && row0 + tid < n_out) {
    key = keys_out[row0 + tid];
    b = (row0 + tid) / g.pad_out;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  const int K = g.ks * g.ks * g.ks;
  for (int k = 0; k < K; ++k) {
    const int hit = tid < TILE_M ? match(g, keys_in, key, b, k) : -1;
    __syncthreads();                  // last offset's readers of smem done
    if (tid < TILE_M) src[tid] = hit;
    if (!__syncthreads_or(hit >= 0)) continue;

    for (int c0 = 0; c0 < g.cin; c0 += KC) {
      if (c0 > 0) __syncthreads();
      gather_rows<KC, LDX>(x, src, g.cin, c0, xs);
      const __nv_bfloat16* wk = w + (size_t)k * g.cin * g.cout + n0;
      for (int i = tid; i < KC * WV; i += THREADS) {
        const int r = i / WV, v = i % WV, c = c0 + r;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (c < g.cin)
          val = __ldg(reinterpret_cast<const uint4*>(wk + (size_t)c * g.cout +
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
        out[(size_t)r * g.cout + n0 + j * 16 + e % 16] =
            to_out(st[e], (OutT*)nullptr);
    }
    __syncwarp();
  }
}

template <int NT, int KC, typename OutT>
void launch(const void* x, const void* keys_in, const void* keys_out,
            const void* w, void* out, const Geom& g, cudaStream_t stream) {
  const int n_out = g.B * g.pad_out;
  dim3 grid((n_out + TILE_M - 1) / TILE_M, g.cout / NT);
  key_conv_kernel<NT, KC, OutT><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(keys_in),
      static_cast<const int*>(keys_out),
      static_cast<const __nv_bfloat16*>(w), static_cast<OutT*>(out), g);
}

template <int KC, typename OutT>
int dispatch(const void* x, const void* keys_in, const void* keys_out,
             const void* w, void* out, const Geom& g, cudaStream_t stream) {
  if (g.B * g.pad_out == 0) return 0;
  if (g.cout % 128 == 0) launch<128, KC, OutT>(x, keys_in, keys_out, w, out, g, stream);
  else if (g.cout % 96 == 0) launch<96, KC, OutT>(x, keys_in, keys_out, w, out, g, stream);
  else if (g.cout % 64 == 0) launch<64, KC, OutT>(x, keys_in, keys_out, w, out, g, stream);
  else if (g.cout % 32 == 0) launch<32, KC, OutT>(x, keys_in, keys_out, w, out, g, stream);
  else if (g.cout % 16 == 0) launch<16, KC, OutT>(x, keys_in, keys_out, w, out, g, stream);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------- weight gradients
constexpr int STEM_KG = 25;      // stem offsets per block (125 = 5 groups)
constexpr int STEM_CIN = 8;      // stem input channels held (cin <= 8)
constexpr int STEM_CO = 32;      // stem output channels held (cout <= 32)

// Input channels of a dw slab: 64 (4 warps) up to cin 64, else 128 (8
// warps), so that cin 96 and 128 gather each tile once, not once per
// 64-channel chunk. Python's key_conv_dw counts the same chunks.
__host__ __device__ constexpr int dw_ci(int cin) { return cin <= 64 ? 64 : 128; }

// Pass 1 of dw for the three _kernel modes. Block (k, s, z): offset k, input
// channels c0 .. c0 + CI and output channels n0 .. n0 + NT (z enumerates the
// chunks), over row tiles s, s + S, ...; their matches come from the table
// (match_table_kernel). Warp w owns input channels
// c0 + 16w .. c0 + 16w + 15 of the slab (a warp past cin idles in the
// products). Writes the slab's partial sum to part[s][k] (a (cin, cout) f32
// block per slice and offset).
template <int NT, int CI>
__global__ void __launch_bounds__(CI * 2)
key_conv_dw_kernel(const __nv_bfloat16* __restrict__ x,
                   const int* __restrict__ table,
                   const __nv_bfloat16* __restrict__ gr,
                   float* __restrict__ part, Geom g) {
  constexpr int NTHR = CI * 2;    // CI / 16 warps
  constexpr int NF = NT / 16;
  constexpr int LDX = CI + 8;
  constexpr int LDG = NT + 8;
  constexpr int GV = NT / 8;
  __shared__ __align__(32) __nv_bfloat16 xs[TILE_M * LDX];
  __shared__ __align__(32) __nv_bfloat16 gs[TILE_M * LDG];
  __shared__ __align__(32) float stage[NTHR / 32][16 * 16];
  __shared__ int src[TILE_M];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_out = g.B * g.pad_out;
  const int n_tiles = (n_out + TILE_M - 1) / TILE_M;
  const int k = blockIdx.x, K = gridDim.x;
  const int s0 = blockIdx.y, n_s = gridDim.y;
  const int n_ci = (g.cin + CI - 1) / CI;
  const int c0 = (blockIdx.z % n_ci) * CI;
  const int n0 = (blockIdx.z / n_ci) * NT;
  const bool active = c0 + warp * 16 < g.cin;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int t = s0; t < n_tiles; t += n_s) {
    const int row0 = t * TILE_M;
    int hit = -1;
    if (tid < TILE_M && row0 + tid < n_out)
      hit = __ldg(table + (size_t)k * n_out + row0 + tid);
    __syncthreads();                  // last tile's readers of smem done
    if (tid < TILE_M) src[tid] = hit;
    if (!__syncthreads_or(hit >= 0)) continue;

    gather_rows<CI, LDX, NTHR>(x, src, g.cin, c0, xs);
    // the tile's g rows, zero where the row matched nothing (a padding row's
    // g never reaches dw, even where it is not finite)
    for (int i = tid; i < TILE_M * GV; i += NTHR) {
      const int r = i / GV, v = i % GV;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (src[r] >= 0)
        val = __ldg(reinterpret_cast<const uint4*>(
            gr + (size_t)(row0 + r) * g.cout + n0 + v * 8));
      *reinterpret_cast<uint4*>(gs + r * LDG + v * 8) = val;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int kk = 0; kk < TILE_M; kk += 16) {
      // x^T: column-major view of the gathered rows
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> a;
      wmma::load_matrix_sync(a, xs + kk * LDX + warp * 16, LDX);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, gs + kk * LDG + j * 16, LDG);
        wmma::mma_sync(acc[j], a, bf, acc[j]);
      }
    }
  }

  float* st = stage[warp];
  float* dst = part + ((size_t)s0 * K + k) * g.cin * g.cout;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int c = c0 + warp * 16 + e / 16;
      if (c < g.cin) dst[(size_t)c * g.cout + n0 + j * 16 + e % 16] = st[e];
    }
    __syncwarp();
  }
}

// Pass 1 of the stem's dw. Block (s, kg): offsets kg*25 .. kg*25 + 24 over
// row tiles s, s + S, ..., matches from the table; the block's share of dw
// stays in shared memory
// (acc[k][c][o]); per tile the g rows are loaded once, then per offset the
// matched x rows (one 16-wide chunk, zeros past cin) are multiplied on the
// tensor cores, warp w owning output channels 16w .. 16w + 15. Writes
// part[s][k] for its 25 offsets.
__global__ void __launch_bounds__(THREADS)
key_conv_stem_dw_kernel(const __nv_bfloat16* __restrict__ x,
                        const int* __restrict__ keys,
                        const int* __restrict__ table,
                        const __nv_bfloat16* __restrict__ gr,
                        float* __restrict__ part, Geom g) {
  constexpr int LDX = 16 + 8;
  constexpr int LDG = STEM_CO + 8;
  constexpr int GV = STEM_CO / 8;
  __shared__ __align__(32) __nv_bfloat16 xs[TILE_M * LDX];
  __shared__ __align__(32) __nv_bfloat16 gs[TILE_M * LDG];
  __shared__ __align__(32) float stage[STEM_CO / 16][16 * 16];
  __shared__ float acc[STEM_KG * STEM_CIN * STEM_CO];
  __shared__ int src[TILE_M];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = g.B * g.pad_out;
  const int n_tiles = (n + TILE_M - 1) / TILE_M;
  const int k0 = blockIdx.y * STEM_KG;
  const int gv = g.cout / 8;
  for (int i = tid; i < STEM_KG * STEM_CIN * STEM_CO; i += THREADS)
    acc[i] = 0.0f;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row0 = t * TILE_M;
    const int key = tid < TILE_M && row0 + tid < n ? keys[row0 + tid]
                                                   : kSentKey;
    __syncthreads();                  // last tile's readers of smem done
    for (int i = tid; i < TILE_M * GV; i += THREADS) {
      const int r = i / GV, v = i % GV;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (v < gv && row0 + r < n && keys[row0 + r] < kSentKey)
        val = __ldg(reinterpret_cast<const uint4*>(
            gr + (size_t)(row0 + r) * g.cout + v * 8));
      *reinterpret_cast<uint4*>(gs + r * LDG + v * 8) = val;
    }
    if (!__syncthreads_or(key < kSentKey)) continue;

    for (int kk = 0; kk < STEM_KG; ++kk) {
      const int hit = key < kSentKey
          ? __ldg(table + (size_t)(k0 + kk) * n + row0 + tid) : -1;
      __syncthreads();                // last offset's readers of xs done
      if (tid < TILE_M) src[tid] = hit;
      if (!__syncthreads_or(hit >= 0)) continue;
      gather_rows<16, LDX>(x, src, g.cin, 0, xs);
      __syncthreads();
      if (warp < g.cout / 16) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> f;
        wmma::fill_fragment(f, 0.0f);
#pragma unroll
        for (int r0 = 0; r0 < TILE_M; r0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bf;
          wmma::load_matrix_sync(a, xs + r0 * LDX, LDX);
          wmma::load_matrix_sync(bf, gs + r0 * LDG + warp * 16, LDG);
          wmma::mma_sync(f, a, bf, f);
        }
        float* st = stage[warp];
        wmma::store_matrix_sync(st, f, 16, wmma::mem_row_major);
        __syncwarp();
        // each (c, o) of dw has one owner lane: no atomics
        for (int e = lane; e < 16 * g.cin; e += 32)
          acc[(kk * STEM_CIN + e / 16) * STEM_CO + warp * 16 + e % 16] +=
              st[e];
        __syncwarp();
      }
    }
  }
  __syncthreads();
  float* dst = part + ((size_t)blockIdx.x * 125 + k0) * g.cin * g.cout;
  for (int i = tid; i < STEM_KG * g.cin * g.cout; i += THREADS) {
    const int kk = i / (g.cin * g.cout), c = (i / g.cout) % g.cin,
              o = i % g.cout;
    dst[i] = acc[(kk * STEM_CIN + c) * STEM_CO + o];
  }
}

// The matched input row (or -1) of every output row at every offset:
// table[k * n_out + v] = match(keys_out[v], k). One search per thread, all
// in flight at once, so the dw kernels read their matches with one
// coalesced load per tile instead of a dependent search chain per tile.
__global__ void match_table_kernel(const int* __restrict__ keys_in,
                                   const int* __restrict__ keys_out,
                                   int* __restrict__ table, Geom g) {
  const int n_out = g.B * g.pad_out;
  const size_t n = (size_t)g.ks * g.ks * g.ks * n_out;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(i / n_out), v = (int)(i % n_out);
    table[i] = match(g, keys_in, __ldg(keys_out + v), v / g.pad_out, k);
  }
}

int match_table(const void* keys_in, const void* keys_out, void* table,
                const Geom& g, cudaStream_t stream) {
  const size_t n = (size_t)g.ks * g.ks * g.ks * g.B * g.pad_out;
  const size_t blocks = (n + 255) / 256;
  match_table_kernel<<<(int)(blocks < 132 * 64 ? blocks : 132 * 64), 256, 0,
                       stream>>>(static_cast<const int*>(keys_in),
                                 static_cast<const int*>(keys_out),
                                 static_cast<int*>(table), g);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: out[i] = sum over the S slices of part[s][i], in slice order.
__global__ void sum_slices_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, size_t n, int S) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int j = 0; j < S; ++j) s += part[(size_t)j * n + i];
    out[i] = s;
  }
}

int sum_slices(const float* part, float* out, size_t n, int S,
               cudaStream_t stream) {
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_slices_kernel<<<blocks, 256, 0, stream>>>(part, out, n, S);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, int CI>
int launch_dw_ci(const void* x, const void* table, const void* gr, void* part,
                 const Geom& g, int slices, cudaStream_t stream) {
  const int n_ci = (g.cin + CI - 1) / CI;
  // offsets fastest: the blocks of one row slice run together and share
  // its g tiles in L2
  dim3 grid(g.ks * g.ks * g.ks, slices, n_ci * (g.cout / NT));
  key_conv_dw_kernel<NT, CI><<<grid, CI * 2, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(table),
      static_cast<const __nv_bfloat16*>(gr), static_cast<float*>(part), g);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_dw(const void* x, const void* table, const void* gr, void* part,
              const Geom& g, int slices, cudaStream_t stream) {
  if (dw_ci(g.cin) == 64)
    return launch_dw_ci<NT, 64>(x, table, gr, part, g, slices, stream);
  return launch_dw_ci<NT, 128>(x, table, gr, part, g, slices, stream);
}

}  // namespace

extern "C" {

// The three modes of key_conv: same-level (ks 3, lo -1, sign 1, guard 1),
// down (ks 2, lo 0, sign 1, guard 0), up (ks 2, lo 0, sign -1, guard 0).
// x (B*pad_in, cin) bf16; keys_in (B, pad_in) i32 sorted, SENT-padded;
// keys_out (B*pad_out,) i32; w (ks^3, cin, cout) bf16; out (B*pad_out, cout)
// f32 (out_bf16 = 0) or bf16. Returns the cudaGetLastError() after launch.
int b2m_key_conv(const void* x, const void* keys_in, const void* keys_out,
                 const void* w, void* out, int B, int pad_in, int pad_out,
                 int cin, int cout, int ks, int lo, int sign, int scale,
                 int guard, int out_bf16, void* stream) {
  const Geom g{B, pad_in, pad_out, cin, cout, ks, lo, sign, scale, guard};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return dispatch<32, __nv_bfloat16>(x, keys_in, keys_out, w, out, g, s);
  return dispatch<32, float>(x, keys_in, keys_out, w, out, g, s);
}

// The 5^3 stem: input space == output space, cin <= 16 (one 16-wide channel
// chunk per offset), f32 out.
int b2m_key_conv_stem(const void* x, const void* keys, const void* w,
                      void* out, int B, int pad, int cin, int cout,
                      void* stream) {
  if (cin > 16) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{B, pad, pad, cin, cout, 5, -2, 1, 1, 1};
  return dispatch<16, float>(x, keys, keys, w, out, g,
                             static_cast<cudaStream_t>(stream));
}

// dw of the three key_conv modes (the same Geom as b2m_key_conv): x
// (B*pad_in, cin) bf16; g (B*pad_out, cout) bf16; part (slices, ks^3, cin,
// cout) f32 and table (ks^3, B*pad_out) i32 scratch; dw (ks^3, cin, cout)
// f32. cout % 16 == 0.
int b2m_key_conv_dw(const void* x, const void* keys_in, const void* keys_out,
                    const void* g, void* part, void* dw, void* table, int B,
                    int pad_in, int pad_out, int cin, int cout, int ks,
                    int lo, int sign, int scale, int guard, int slices,
                    void* stream) {
  const Geom geo{B, pad_in, pad_out, cin, cout, ks, lo, sign, scale, guard};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slices < 1 || cout % 16) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = (size_t)ks * ks * ks * cin * cout;
  int rc;
  if (B * pad_out == 0 || n == 0) {
    rc = static_cast<int>(cudaMemsetAsync(dw, 0, n * sizeof(float), s));
    return rc ? rc : static_cast<int>(cudaGetLastError());
  }
  rc = match_table(keys_in, keys_out, table, geo, s);
  if (rc) return rc;
  if (cout % 128 == 0) rc = launch_dw<128>(x, table, g, part, geo, slices, s);
  else if (cout % 96 == 0) rc = launch_dw<96>(x, table, g, part, geo, slices, s);
  else if (cout % 64 == 0) rc = launch_dw<64>(x, table, g, part, geo, slices, s);
  else if (cout % 32 == 0) rc = launch_dw<32>(x, table, g, part, geo, slices, s);
  else rc = launch_dw<16>(x, table, g, part, geo, slices, s);
  if (rc) return rc;
  return sum_slices(static_cast<const float*>(part), static_cast<float*>(dw),
                    n, slices, s);
}

// dw of the 5^3 stem: x (B*pad, cin <= 8) bf16; g (B*pad, cout) bf16 with
// cout 16 or 32; part (slices, 125, cin, cout) f32 and table (125, B*pad)
// i32 scratch; dw (125, cin, cout) f32.
int b2m_key_conv_stem_dw(const void* x, const void* keys, const void* g,
                         void* part, void* dw, void* table, int B, int pad,
                         int cin, int cout, int slices, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || cin > STEM_CIN || (cout != 16 && cout != STEM_CO) ||
      slices < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = (size_t)125 * cin * cout;
  if (B * pad == 0) {
    const int rc = static_cast<int>(cudaMemsetAsync(dw, 0, n * sizeof(float), s));
    return rc ? rc : static_cast<int>(cudaGetLastError());
  }
  const Geom geo{B, pad, pad, cin, cout, 5, -2, 1, 1, 1};
  int rc = match_table(keys, keys, table, geo, s);
  if (rc) return rc;
  key_conv_stem_dw_kernel<<<dim3(slices, 125 / STEM_KG), THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(keys),
      static_cast<const int*>(table), static_cast<const __nv_bfloat16*>(g),
      static_cast<float*>(part), geo);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  return sum_slices(static_cast<const float*>(part), static_cast<float*>(dw),
                    n, slices, s);
}

}  // extern "C"
