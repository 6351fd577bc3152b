// Packed-key sparse convolution for Hopper (sm_90a), bound through a plain C
// interface (ctypes; box2mask_torch/sparse/_build.py builds this file).
//
// Replaces the four Pallas TPU kernels of box2mask_tpu/sparse/key_conv.py:
//   * _kernel (:116, via key_conv :277): 3^3 same-level conv (guarded),
//     2^3 stride-2 down conv (stride_child), transpose up conv (stride_parent);
//   * _stem_kernel (:542, via key_conv_stem :637): the 5^3 stem, f32 out;
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
// Bound on the H100: at the main path's shapes the matched pairs' FLOPs
// (2 * hits * cin * cout) are far under the 989 TFLOP/s bf16 peak, so the
// bound is the bytes (x and g read once, out or dw written once, keys, w)
// over 3.35 TB/s. What holds a gather-GEMM conv far from it on this card is
// less the key search (a neighbor-map read in its place, csrc/nmap_conv.cu,
// runs the same tile) than a serial chain per offset: match, vote,
// blocking gather, blocking w load, barrier, a few tensor-core steps, with
// nothing in flight meanwhile; the tile of csrc/conv_tile.cuh breaks it.
//
// Forward design: the tile of csrc/conv_tile.cuh (matches for all offsets
// up front, the live-offset list, a cp.async / bulk-copy ring, wgmma, 16-byte
// epilogue stores; M = 128 rows). Here its matches come from a branchless
// binary search of the scene's sorted key row (pad_in keys; a ScanNet-scale
// row is 512 KB and stays in the 50 MB L2), sixteen independent searches per
// thread in lockstep so that their loads are in flight together. The TPU's
// one-hot gather matmul, 128-lane windows and host window plans have no
// part here.
//
// Weight-gradient design. The TPU kernel carries one (K, cin, cout) sum
// through its sequential grid over dense row windows; here blocks run in
// parallel over the matched pairs alone. Bound on the H100: at the main
// path's shapes only 0.4-26% of the (offset, output row) products are
// matched pairs (a level's pad dwarfs its rows; PERF.md), and what the
// pairs cost is the gather of an x row and a g row per pair (L2 holds the
// rows that several offsets share) under the tensor cores' work; a dense
// walk of 64-row tiles x offsets, skipping a product only where no row of
// the tile matched, multiplied mostly zero rows and, at the deep levels,
// walked ~1000 near-empty tiles in series per block. So the dw first builds
// per-offset lists of matched (input row, output row) pairs on the card and
// multiplies tiles of pairs only:
//   * match_table_kernel: every (offset, output row) search at once, PAIR_RPT
//     searches per thread in lockstep, into an int32 match table, and the
//     hits of each PAIR_CH-row chunk per offset;
//   * match_table_kernel_scan (one block): each offset's chunk offsets, its
//     pair count, and the work items: chunks of `chunk` pairs (a multiple of
//     64, from the total so that the items make about two waves of blocks),
//     numbered offset by offset; the items in flight together take the
//     same row ranges of several offsets, whose x and g rows L2 shares;
//   * key_conv_dw_kernel_pairs: a stable compaction of each offset's hits
//     into its list, in output-row order (misses, guarded axis wraps and
//     SENT rows never enter one);
//   * key_conv_dw_kernel: a block takes one item (one offset's chunk of
//     pairs) and CI input x NT output channels, and walks its 64-pair tiles
//     through a ring of 2-4 stages: per tile the pairs, one ring turn
//     ahead, then the x and g rows by cp.async (zeros past the item's last
//     pair) while the previous tile is multiplied; the 8 warps share the
//     (CW input, NB output channels) units, mma.sync m16n8k16 with both
//     operands loaded by ldmatrix.trans, f32 accumulators in registers; it
//     writes its (cin, cout) slab to the item's partial;
//   * sum_slices_kernel_items: dw[k] = the sum of offset k's item partials
//     in item order.
// The pair counts stay on the card: the host sizes every grid from the
// shapes, and a block past the last item exits at once. No atomics: the
// result is the same bit for bit from run to run. The table is dead once
// the lists are built, so the partials reuse its memory.
//
// Stem weight-gradient design (K = 125, cin <= 8, cout 16 or 32). Bound on
// the H100: the bytes (x, keys and the f32 g the backward gives read once,
// dw written once); what held a first design 200x above it was a 125-offset
// match table written to device memory and read back, a separate g cast
// pass and a serial search-gather-multiply chain per offset. Here no table:
// the 5 offsets dz = -2..2 of one (dx, dy) are consecutive packed keys, so a
// block (one dx group of 25 offsets, a contiguous run of row tiles) makes
// one search per (row, dy), mostly in shared memory over samples of the
// only stretch of keys its queries can reach, and reads the 5 entries from
// there; g is rounded to bf16 in the kernel; each tile's im2col (64 rows x
// 25 offsets x 8 channels) is gathered by cp.async one iteration ahead and
// multiplied as im2col^T g, the TPU kernel's product, on mma.sync; one wave
// of blocks, pass 2 in slice order. What holds it now is each block's
// chain of search loads per tile, which other blocks on the SM only partly
// cover (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"
#include "dw_plan.cuh"
#include "hopper.cuh"

namespace {

constexpr int kSentKey = 1 << 30;
constexpr int kAxisBits = 10;
constexpr int kAxisMax = 1 << kAxisBits;

struct Geom {
  int B, pad_in, pad_out, cin, cout;
  int ks;      // offsets per axis (3 or 5 same-level, 2 strided)
  int lo;      // first offset per axis (-ks/2, or 0 for the strided sets)
  int sign;    // +1, or -1 for the transpose (stride_parent) conv
  int scale;   // 2^level
  int guard;   // mask axis wraps of the unpacked fields
};

// The key searched for output key `key` at offset k (x-major over ks^3,
// fields lo .. lo+ks-1 times scale), or -1 when nothing can match. Packed
// deltas are arithmetic sums (negative fields borrow); the transpose conv's
// queries go negative at scene borders and match nothing.
__device__ __forceinline__ int query(const Geom& g, int key, int k) {
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
  return q < 0 ? -1 : q;
}

// Row of keys_in matched by output key `key` of scene b at offset k, or -1.
__device__ __forceinline__ int match(const Geom& g,
                                     const int* __restrict__ keys_in, int key,
                                     int b, int k) {
  const int q = query(g, key, k);
  if (q < 0) return -1;
  const int* krow = keys_in + (size_t)b * g.pad_in;
  int lo = 0, hi = g.pad_in;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(krow + mid) < q) lo = mid + 1; else hi = mid;
  }
  return (lo < g.pad_in && __ldg(krow + lo) == q) ? b * g.pad_in + lo : -1;
}

// ---------------------------------------------------------------- forward
// The tile's matches: its keys into aux, then every (offset, row) pair by a
// branchless lower bound over the scene's key row, NS searches per thread
// in lockstep so that their loads are in flight together.
struct KeyMatches {
  Geom g;
  const int* __restrict__ keys_in;
  const int* __restrict__ keys_out;
  int row0, n_out, K;

  __device__ __forceinline__ void operator()(int* mt, int* aux) const {
    using conv_tile::M;
    using conv_tile::MS;
    constexpr int NTHR = conv_tile::THREADS, NS = 16;
    for (int r = threadIdx.x; r < M; r += NTHR)
      aux[r] = row0 + r < n_out ? __ldg(keys_out + row0 + r) : kSentKey;
    __syncthreads();
    const int total = K * M;
    for (int i0 = threadIdx.x; i0 < total; i0 += NTHR * NS) {
      int q[NS], base[NS];
      const int* kr[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int i = i0 + j * NTHR;
        q[j] = -1;
        base[j] = 0;
        kr[j] = keys_in;
        if (i < total) {
          const int r = i % M;
          const int b = min(row0 + r, n_out - 1) / g.pad_out;
          q[j] = query(g, aux[r], i / M);
          kr[j] = keys_in + (size_t)b * g.pad_in;
        }
      }
      for (int len = g.pad_in; len > 1;) {
        const int half = len >> 1;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          if (q[j] >= 0 && __ldg(kr[j] + base[j] + half) < q[j])
            base[j] += half;
        len -= half;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int i = i0 + j * NTHR;
        if (i >= total) continue;
        int hit = -1;
        if (q[j] >= 0) {
          const int p = base[j] + (__ldg(kr[j] + base[j]) < q[j]);
          if (p < g.pad_in && __ldg(kr[j] + p) == q[j])
            hit = (int)(kr[j] - keys_in) + p;
        }
        mt[(i / M) * MS + i % M] = hit;
      }
    }
  }
};

template <int NT, typename OutT>
__global__ void __launch_bounds__(conv_tile::THREADS)
key_conv_kernel(const __nv_bfloat16* __restrict__ x,
                const int* __restrict__ keys_in,
                const int* __restrict__ keys_out,
                const __nv_bfloat16* __restrict__ wp,
                OutT* __restrict__ out, Geom g, int stages, int ips) {
  const int n_out = g.B * g.pad_out, K = g.ks * g.ks * g.ks;
  const KeyMatches m{g, keys_in, keys_out, (int)blockIdx.x * conv_tile::M,
                     n_out, K};
  conv_tile::conv_tile<NT>(x, wp, out, n_out, g.cin, g.cout, K, stages, ips,
                           m);
}

template <int NT, typename OutT>
int launch(const void* x, const void* keys_in, const void* keys_out,
           const void* w, void* wp, void* out, const Geom& g,
           cudaStream_t stream) {
  const int K = g.ks * g.ks * g.ks;
  int rc = conv_tile::pack_w(w, wp, K, g.cin, g.cout, NT, stream);
  if (rc) return rc;
  return conv_tile::launch_tile<NT, key_conv_kernel<NT, OutT>>(
      g.B * g.pad_out, g.cin, g.cout, K, stream,
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(keys_in),
      static_cast<const int*>(keys_out),
      static_cast<const __nv_bfloat16*>(wp), static_cast<OutT*>(out), g);
}

template <typename OutT>
int dispatch(const void* x, const void* keys_in, const void* keys_out,
             const void* w, void* wp, void* out, const Geom& g,
             cudaStream_t s) {
  if (g.B * g.pad_out == 0) return 0;
  if (g.cin < 1 || g.cin % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (g.cout % 128 == 0) return launch<128, OutT>(x, keys_in, keys_out, w, wp, out, g, s);
  if (g.cout % 96 == 0) return launch<96, OutT>(x, keys_in, keys_out, w, wp, out, g, s);
  if (g.cout % 64 == 0) return launch<64, OutT>(x, keys_in, keys_out, w, wp, out, g, s);
  if (g.cout % 32 == 0) return launch<32, OutT>(x, keys_in, keys_out, w, wp, out, g, s);
  if (g.cout % 16 == 0) return launch<16, OutT>(x, keys_in, keys_out, w, wp, out, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------- weight gradients
// constants, DwPlan and DwScratch: csrc/dw_plan.cuh
using namespace dw_plan;

// the SMs of the current device (132 on the H100 SXM)
int sm_count() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(p)));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// Pass 0 of dw: table[k * n_pad + v] = the input row that output row v
// matches at offset k, or -1 (rows v < n_out), and counts[k * n_chunks + j]
// = the hits among chunk j's PAIR_CH rows. Block (j, k); each thread makes
// its PAIR_RPT searches (rows strided by the block, coalesced) as branchless
// lower bounds in lockstep, so that their loads are in flight together.
__global__ void __launch_bounds__(DW_THREADS)
match_table_kernel(const int* __restrict__ keys_in,
                   const int* __restrict__ keys_out, int* __restrict__ table,
                   int* __restrict__ counts, Geom g, int n_pad) {
  __shared__ int warp_n[DW_WARPS];
  const int n_out = g.B * g.pad_out, k = blockIdx.y;
  const int v0 = blockIdx.x * PAIR_CH + threadIdx.x;
  int q[PAIR_RPT], base[PAIR_RPT];
  const int* kr[PAIR_RPT];
#pragma unroll
  for (int r = 0; r < PAIR_RPT; ++r) {
    const int v = v0 + r * DW_THREADS;
    q[r] = -1;
    base[r] = 0;
    kr[r] = keys_in;
    if (v < n_out && g.pad_in > 0) {
      q[r] = query(g, __ldg(keys_out + v), k);
      kr[r] = keys_in + (size_t)(v / g.pad_out) * g.pad_in;
    }
  }
  for (int len = g.pad_in; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int r = 0; r < PAIR_RPT; ++r)
      if (q[r] >= 0 && __ldg(kr[r] + base[r] + half) < q[r]) base[r] += half;
    len -= half;
  }
  int n = 0;
#pragma unroll
  for (int r = 0; r < PAIR_RPT; ++r) {
    const int v = v0 + r * DW_THREADS;
    if (v >= n_out) continue;
    int hit = -1;
    if (q[r] >= 0) {
      const int p = base[r] + (__ldg(kr[r] + base[r]) < q[r]);
      if (p < g.pad_in && __ldg(kr[r] + p) == q[r])
        hit = (int)(kr[r] - keys_in) + p;
    }
    table[(size_t)k * n_pad + v] = hit;
    n += hit >= 0;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) n += __shfl_xor_sync(0xffffffffu, n, d);
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < DW_WARPS; ++w) s += warp_n[w];
    counts[(size_t)k * gridDim.x + blockIdx.x] = s;
  }
}

// Pass 1 (one block): each offset's chunk counts become the offsets of the
// chunks' hits in its list (a warp per offset) and its pair count; then the
// work items: chunks of `chunk` pairs, chunk = total / target rounded up to
// a multiple of DW_M, item c of offset k covering its pairs c * chunk ..,
// numbered offset by offset, so that at most target + K items exist.
// Integer arithmetic only: the same counts give the same items.
__global__ void __launch_bounds__(1024)
match_table_kernel_scan(int* __restrict__ counts, int* __restrict__ meta,
                        int K, int n_chunks, int target) {
  // the per-offset pair counts pass from the warps to thread 0 in shared
  // memory
  __shared__ int s_pairs[DW_KMAX];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int k = tid >> 5; k < K; k += blockDim.x >> 5) {
    int* c = counts + (size_t)k * n_chunks;
    int run = 0;
    for (int i0 = 0; i0 < n_chunks; i0 += 32) {
      const int i = i0 + lane;
      const int v = i < n_chunks ? c[i] : 0;
      const int s = warp_inclusive_sum(v);
      if (i < n_chunks) c[i] = run + s - v;
      run += __shfl_sync(0xffffffffu, s, 31);
    }
    if (lane == 0) s_pairs[k] = run;
  }
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int k = 0; k < K; ++k) total += s_pairs[k];
    long long chunk = (total + target - 1) / target;
    chunk = (chunk + DW_M - 1) / DW_M * DW_M;
    if (chunk < DW_M) chunk = DW_M;
    int n_items = 0;
    for (int k = 0; k < K; ++k) {
      const int items = (int)((s_pairs[k] + chunk - 1) / chunk);
      meta[DW_META + 3 * k] = s_pairs[k];
      meta[DW_META + 3 * k + 1] = items;
      meta[DW_META + 3 * k + 2] = n_items;
      n_items += items;
    }
    meta[0] = n_items;
    meta[1] = (int)chunk;
    meta[2] = target;
  }
}

// Pass 2: the pair lists. Block (j, k) moves the hits of chunk j's rows at
// offset k, in row order, to pairs[k * n_pad + offset of chunk j ..] as
// (input row, output row): each thread owns PAIR_RPT consecutive rows (two
// 16-byte table loads) and a block scan places its hits.
__global__ void __launch_bounds__(DW_THREADS)
key_conv_dw_kernel_pairs(const int* __restrict__ table,
                         const int* __restrict__ counts,
                         int2* __restrict__ pairs, int n_out, int n_pad) {
  __shared__ int warp_n[DW_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = blockIdx.y;
  const int v0 = blockIdx.x * PAIR_CH + tid * PAIR_RPT;
  int src[PAIR_RPT];
#pragma unroll
  for (int r = 0; r < PAIR_RPT; ++r) src[r] = -1;
  // n_pad % PAIR_RPT == 0: a thread's rows lie all inside the table's row
  // or all past it
  if (v0 < n_pad) {
    const int4* t = reinterpret_cast<const int4*>(table + (size_t)k * n_pad +
                                                  v0);
    const int4 a = t[0], b = t[1];
    src[0] = a.x, src[1] = a.y, src[2] = a.z, src[3] = a.w;
    src[4] = b.x, src[5] = b.y, src[6] = b.z, src[7] = b.w;
  }
  int n = 0;
#pragma unroll
  for (int r = 0; r < PAIR_RPT; ++r) {
    if (v0 + r >= n_out) src[r] = -1;
    n += src[r] >= 0;
  }
  const int s = warp_inclusive_sum(n);
  if (lane == 31) warp_n[warp] = s;
  __syncthreads();
  int pos = counts[(size_t)k * gridDim.x + blockIdx.x] + s - n;
  for (int w = 0; w < warp; ++w) pos += warp_n[w];
  int2* dst = pairs + (size_t)k * n_pad;
#pragma unroll
  for (int r = 0; r < PAIR_RPT; ++r)
    if (src[r] >= 0) dst[pos++] = make_int2(src[r], v0 + r);
}

// Pass 3 of dw for the three _kernel modes. Block (z, i): work item i,
// chunk c = i - first item of offset k, the pairs c * chunk .. of k's list, input
// channels c0 .. c0 + CI and output channels n0 .. n0 + NT (z enumerates
// the channel blocks, fastest, so that the blocks of one item run side by
// side); i >= the item count exits. Writes the block's slab of the item's
// partial sum to part[first item of k + c] (a (cin, cout) f32 block).
template <int NB, int CW, int UPW>
__global__ void __launch_bounds__(DW_THREADS)
key_conv_dw_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ gr,
                   const int2* __restrict__ pairs,
                   const int* __restrict__ meta, float* __restrict__ part,
                   int K, int cin, int cout, int n_pad, int CI, int NT,
                   int stages) {
  const int it = blockIdx.y;
  if (it >= __ldg(meta)) return;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the item's offset: the last whose first item is at most it (first
  // items ascend; an offset without items shares the next one's)
  const int k = __syncthreads_count(
      tid < K && __ldg(meta + DW_META + 3 * tid + 2) <= it) - 1;
  const int* mk = meta + DW_META + 3 * k;
  const int ch = it - __ldg(mk + 2);
  const int chunk = __ldg(meta + 1);
  const int p0 = ch * chunk;
  const int n_pairs = min(chunk, __ldg(mk) - p0);
  const int n_my = (n_pairs + DW_M - 1) / DW_M;
  const int n_ci = (cin + CI - 1) / CI;
  const int c0 = (blockIdx.x % n_ci) * CI, n0 = (blockIdx.x / n_ci) * NT;
  const int LDX = CI + 8, LDG = NT + 8;
  const int nbs = NT / NB, upo = (CI / CW) * nbs;
  const int2* list = pairs + (size_t)k * n_pad + p0;

  __nv_bfloat16* gs0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs0 = gs0 + stages * DW_M * LDG;
  int2* ix0 = reinterpret_cast<int2*>(xs0 + stages * DW_M * LDX);
  auto slot = [&](int i) { return ix0 + (i % (2 * stages)) * DW_M; };

  // the pairs of tile j, one ring turn ahead: 16 bytes (two pairs) a copy,
  // none past the item's last pair (the gathers read only pairs below
  // n_pairs)
  auto load_idx = [&](int j) {
    if (j >= n_my || tid >= DW_M / 2) return;
    const int p = j * DW_M + 2 * tid;
    hopper::cp_async16(slot(j) + 2 * tid, p < n_pairs ? list + p : list,
                       p < n_pairs ? 16 : 0);
  };
  // tile i's g and x rows into stage i % stages, zeros past the item's
  // last pair. Thread t moves pair (t / 2) % 64, chunks (t % 2) + 2 (t /
  // 128) + 4j: a warp reads pairs of 16-byte chunks of 16 rows.
  const int lr = (tid >> 1) & (DW_M - 1), lc = (tid & 1) + 2 * (tid >> 7);
  const int gv = NT / 8, xv = CI / 8;
  auto issue = [&](int i) {
    load_idx(i + stages - 1);
    if (i >= n_my) return;
    const int st = i % stages;
    const bool ok = i * DW_M + lr < n_pairs;
    const int2 pr = ok ? slot(i)[lr] : make_int2(-1, 0);
    __nv_bfloat16* gs = gs0 + st * DW_M * LDG + lr * LDG;
    const __nv_bfloat16* gsrc = gr + (size_t)pr.y * cout + n0;
    for (int cv = lc; cv < gv; cv += 4)
      hopper::cp_async16(gs + cv * 8, ok ? gsrc + cv * 8 : gr, ok ? 16 : 0);
    __nv_bfloat16* xs = xs0 + st * DW_M * LDX + lr * LDX;
    for (int cv = lc; cv < xv; cv += 4)
      conv_tile::gather8(xs + cv * 8, x, pr.x, cin, c0 + cv * 8);
  };

  // this warp's units: (CW input channels, NB outputs)
  int u_x[UPW], u_g[UPW];
  bool u_on[UPW];
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    const int unit = warp + DW_WARPS * u;
    u_on[u] = unit < upo;
    u_x[u] = (unit / nbs) * CW;
    u_g[u] = (unit % nbs) * NB;
  }
  const int a_off = ((lane & 7) + ((lane >> 4) & 1) * 8) * LDX +
                    ((lane >> 3) & 1) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDG +
                    ((lane >> 4) & 1) * 8;

  float acc[UPW][CW / 16][NB / 8][4];
#pragma unroll
  for (int u = 0; u < UPW; ++u)
#pragma unroll
    for (int c2 = 0; c2 < CW / 16; ++c2)
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][c2][j][e] = 0.0f;

  for (int m = 0; m < stages - 1; ++m) load_idx(m);
  hopper::cp_async_commit();
  hopper::cp_async_wait(0);
  __syncthreads();            // the first stages - 1 tiles' pairs
  for (int m = 0; m < stages - 1; ++m) {
    issue(m);
    hopper::cp_async_commit();
  }
  for (int i = 0; i < n_my; ++i) {
    hopper::cp_async_wait(stages - 2);
    __syncthreads();            // tile i landed; tile i - 1's products done
    issue(i + stages - 1);
    hopper::cp_async_commit();

    const int st = i % stages;
    const __nv_bfloat16* gs = gs0 + st * DW_M * LDG + b_off;
    const __nv_bfloat16* xs = xs0 + st * DW_M * LDX + a_off;
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      if (!u_on[u]) continue;
#pragma unroll
      for (int ks = 0; ks < DW_M / 16; ++ks) {
        uint32_t a[CW / 16][4];
#pragma unroll
        for (int c2 = 0; c2 < CW / 16; ++c2)
          ldsm_x4_trans(a[c2], xs + u_x[u] + c2 * 16 + ks * 16 * LDX);
#pragma unroll
        for (int hh = 0; hh < NB / 16; ++hh) {
          uint32_t b[4];
          ldsm_x4_trans(b, gs + u_g[u] + ks * 16 * LDG + hh * 16);
#pragma unroll
          for (int c2 = 0; c2 < CW / 16; ++c2) {
            mma16816(acc[u][c2][2 * hh], a[c2], b[0], b[1]);
            mma16816(acc[u][c2][2 * hh + 1], a[c2], b[2], b[3]);
          }
        }
      }
    }
  }

  float* dst = part + (size_t)it * cin * cout;
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    if (!u_on[u]) continue;
#pragma unroll
    for (int c2 = 0; c2 < CW / 16; ++c2)
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + u_x[u] + c2 * 16 + (lane >> 2) + 8 * h;
          const int n = n0 + u_g[u] + j * 8 + (lane & 3) * 2;
          if (c < cin)
            *reinterpret_cast<float2*>(dst + (size_t)c * cout + n) =
                make_float2(acc[u][c2][j][2 * h], acc[u][c2][j][2 * h + 1]);
        }
  }
}

// Pass 4: dw[k] = the sum of offset k's item partials, in item order (zeros
// for an offset without pairs).
__global__ void sum_slices_kernel_items(const float* __restrict__ part,
                                        float* __restrict__ out,
                                        const int* __restrict__ meta, int K,
                                        size_t per_k) {
  const size_t n = (size_t)K * per_k;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int* mk = meta + DW_META + 3 * (int)(i / per_k);
    const int items = mk[1];
    const float* p = part + (size_t)mk[2] * per_k + i % per_k;
    float s = 0.0f;
    for (int c = 0; c < items; ++c) s += p[(size_t)c * per_k];
    out[i] = s;
  }
}

struct DwArgs {
  const void *x, *keys_in, *keys_out, *g;
  void *dw, *scratch;
  Geom geo;
};

// The pair-list build (passes 0-2) and, with `multiply`, passes 3-4, for
// the plan's instantiation: as many blocks per SM as the registers allow
// (up to 4), then as many stages (2..4) as fit beside them; the items'
// target is DW_WAVES waves of the blocks the SMs hold, over the n_z
// channel blocks of an item, less K for the offsets' last items.
template <int NB, int CW, int UPW>
int dw_run(const DwArgs& a, const DwPlan& p, bool multiply,
           cudaStream_t stream) {
  constexpr auto kernel = key_conv_dw_kernel<NB, CW, UPW>;
  const Geom& g = a.geo;
  const int K = g.ks * g.ks * g.ks, n_out = g.B * g.pad_out;
  const int regs = conv_tile::kernel_regs<kernel>();
  const int by_regs = 65536 / (((regs + 7) / 8 * 8) * DW_THREADS);
  int stages = 0;
  for (int b = by_regs < 4 ? by_regs : 4; b >= 1 && !stages; --b)
    for (int st = 4; st >= 2 && !stages; --st)
      if (b * (p.bytes(st) + 1024) <= conv_tile::SMEM_SM) stages = st;
  if (!stages) stages = 2;
  const int bytes = p.bytes(stages);
  if (bytes > conv_tile::SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int rc = conv_tile::allow_smem<kernel>(bytes);
  if (rc) return rc;
  int per_sm = 1;
  const int sms = sm_count();
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DW_THREADS,
                                                bytes);
  if (per_sm > DW_BLOCKS_SM) per_sm = DW_BLOCKS_SM;
  int target = DW_WAVES * (per_sm > 0 ? per_sm : 1) * sms / p.n_z - K;
  const DwScratch sc(n_out, K, g.cin, g.cout, sms);
  if (target < K) target = K;
  if (target > sc.cap - K) target = sc.cap - K;
  int* s = static_cast<int*>(a.scratch);
  int2* pairs = reinterpret_cast<int2*>(s + sc.pairs);
  match_table_kernel<<<dim3(sc.n_chunks, K), DW_THREADS, 0, stream>>>(
      static_cast<const int*>(a.keys_in), static_cast<const int*>(a.keys_out),
      s + sc.table, s + sc.counts, g, sc.n_pad);
  match_table_kernel_scan<<<1, 1024, 0, stream>>>(
      s + sc.counts, s + sc.meta, K, sc.n_chunks, target);
  key_conv_dw_kernel_pairs<<<dim3(sc.n_chunks, K), DW_THREADS, 0, stream>>>(
      s + sc.table, s + sc.counts, pairs, n_out, sc.n_pad);
  if (!multiply) return static_cast<int>(cudaGetLastError());
  float* part = reinterpret_cast<float*>(s + sc.table);
  kernel<<<dim3(p.n_z, target + K), DW_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a.x),
      static_cast<const __nv_bfloat16*>(a.g), pairs, s + sc.meta, part, K,
      g.cin, g.cout, sc.n_pad, p.CI, p.NT, stages);
  const size_t per_k = (size_t)g.cin * g.cout, n = K * per_k;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_slices_kernel_items<<<blocks, 256, 0, stream>>>(
      part, static_cast<float*>(a.dw), s + sc.meta, K, per_k);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for the plan's unit shape (NB, CW) and units per warp:
// 32 x 32 units take at most 2 a warp, 16-input units at most 4, 16-output
// units (NT = 16) one
int dw_dispatch(const DwArgs& a, bool multiply, cudaStream_t s) {
  const DwPlan p(a.geo.cin, a.geo.cout);
  if (p.NB == 32 && p.CW == 32) {
    if (p.UPW == 1) return dw_run<32, 32, 1>(a, p, multiply, s);
    if (p.UPW == 2) return dw_run<32, 32, 2>(a, p, multiply, s);
  } else if (p.NB == 32) {
    if (p.UPW == 1) return dw_run<32, 16, 1>(a, p, multiply, s);
    if (p.UPW == 2) return dw_run<32, 16, 2>(a, p, multiply, s);
    if (p.UPW == 3) return dw_run<32, 16, 3>(a, p, multiply, s);
    if (p.UPW == 4) return dw_run<32, 16, 4>(a, p, multiply, s);
  } else if (p.UPW == 1) {
    if (p.CW == 32) return dw_run<16, 32, 1>(a, p, multiply, s);
    return dw_run<16, 16, 1>(a, p, multiply, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The checks and the empty launch (no output rows: dw and meta zero) of
// the two entry points below.
int dw_entry(const DwArgs& a, bool multiply, cudaStream_t s) {
  const Geom& g = a.geo;
  const int K = g.ks * g.ks * g.ks;
  if (K > DW_KMAX || g.cout % 16 || g.cin % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = (size_t)K * g.cin * g.cout;
  if (g.B * g.pad_out > 0 && n > 0) return dw_dispatch(a, multiply, s);
  const DwScratch sc(g.B * g.pad_out, K, g.cin, g.cout, sm_count());
  int rc = static_cast<int>(cudaMemsetAsync(
      static_cast<int*>(a.scratch) + sc.meta, 0,
      (DW_META + 3 * (size_t)K) * sizeof(int), s));
  if (!rc && multiply)
    rc = static_cast<int>(cudaMemsetAsync(a.dw, 0, n * sizeof(float), s));
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- stem dw
// The stem's dw, dw[k, c, o] = sum_v im2col[v, (k, c)] * g[v, o] over the
// 125 offsets of the 5^3 stem (cin <= 8, cout 16 or 32). Block (dx group
// gx, slice s) owns the 25 offsets of one dx, (gx, dy, dz) x-major, over a
// contiguous run of row tiles; per tile it builds a (64 rows x 25 offsets x
// 8 channels) bf16 im2col in shared memory and multiplies its transpose
// with the tile's g on the tensor cores.
constexpr int STEM_M = 64;                  // rows per tile (product depth)
constexpr int STEM_THREADS = 256;           // 8 warps
constexpr int STEM_G = 25;                  // offsets per block: one dx
constexpr int STEM_UM = 13;                 // 16-column units of the im2col
constexpr int STEM_LDA = STEM_UM * 16 + 8;  // im2col row stride (bf16)
constexpr int STEM_ITEMS = STEM_M * 5;      // (row, dy) searches per tile
constexpr int STEM_SAMPLES = 1024;          // key samples held per block

// two stages of im2col, g and matches (an int and a byte per item), and
// the samples: 71-73 KB, three blocks per SM
int stem_dw_bytes(int cout) {
  return 2 * (STEM_M * STEM_LDA * 2 + STEM_M * (cout + 8) * 2 +
              STEM_ITEMS * 5) + STEM_SAMPLES * 4;
}

// Pass 1 of the stem's dw. Block (dx group gx, slice s) owns a contiguous
// run of tiles. Per tile, each (row, dy) item makes ONE search: a key packs
// x << 20 | y << 10 | z, so the queries of dz = -2..2 (within the z range:
// the axis guard) are consecutive integers and their matches are
// consecutive entries of the scene's sorted key row. The lower bound of the
// first query, then the 5 entries from there, give all 5 matches. Every
// lower bound of the block's queries lies in one stretch [P0, P1] of the
// flat key array (the lower bounds of its first row's least and its last
// row's greatest query), so the search runs over every 2^sl-th key of that
// stretch in shared memory (at most STEM_SAMPLES, loaded once) and then
// over the < 2^sl keys between two samples in device memory: at the main
// path's shapes sl = 4, one cache line, where a search of the whole row
// was a chain of ~17 dependent loads. An item keeps its first entry p and
// a 5-bit hit mask in shared memory; one iteration later each hit moves its
// x row (8 bf16 channels, 16 bytes) into the im2col by cp.async,
// zero-filled for a miss. The tile's g rows (f32 or bf16; zeros for SENT
// rows) are loaded into registers and rounded to bf16 (nearest even) on
// their way into shared memory. Per iteration i: the gathers of tile i + 1
// are issued, then tile i + 2 is searched and tile i multiplied while they
// fly (two im2col and g stages, two match slots). 13 x cout/16 units (two
// offsets x 8 channels, 16 outputs) are spread over the 8 warps; mma.sync
// m16n8k16 with both
// operands from ldmatrix.trans, f32 accumulators in registers across all
// the block's tiles. No (unit, 16-row step) is skipped: a test per step,
// whether on the hits in shared memory or on bits set by warp ballots at
// search time, cost more than the products it saved (85% of the im2col is
// zeros). The block writes its (25, cin, cout) slab to part[s].
template <int NO, typename GT>
__global__ void __launch_bounds__(STEM_THREADS, 3)
key_conv_stem_dw_kernel(const __nv_bfloat16* __restrict__ x,
                        const int* __restrict__ keys,
                        const GT* __restrict__ gr, float* __restrict__ part,
                        int n, int pad, int cin) {
  constexpr int LDG = NO + 8;
  constexpr int NBS = NO / 16;
  constexpr int UNITS = STEM_UM * NBS;
  constexpr int UPW = (UNITS + 7) / 8;
  constexpr int GCH = NO / 8;                 // 8-value g chunks per row
  constexpr int NS = (STEM_ITEMS + STEM_THREADS - 1) / STEM_THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* as0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* gs0 = as0 + 2 * STEM_M * STEM_LDA;
  int* mp0 = reinterpret_cast<int*>(gs0 + 2 * STEM_M * LDG);
  unsigned char* mm0 = reinterpret_cast<unsigned char*>(mp0 + 2 * STEM_ITEMS);
  int* samp = reinterpret_cast<int*>(mm0 + 2 * STEM_ITEMS);
  __shared__ int stretch[2];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int dx = (int)blockIdx.x - 2;
  const int n_tiles = (n + STEM_M - 1) / STEM_M;
  const int per = (n_tiles + gridDim.y - 1) / gridDim.y;
  const int t0 = blockIdx.y * per;
  const int n_my = max(0, min(per, n_tiles - t0));

  // P0, P1: the lower bounds of key[R0] + (dx, -2, -2) and key[R1 - 1] +
  // (dx, 2, 2) in their scenes' rows (packed sums: no overflow, SENT = 2^30)
  if (tid < 2) {
    int pos = 0;
    if (n_my > 0) {
      const int v = tid ? min((t0 + n_my) * STEM_M, n) - 1 : t0 * STEM_M;
      const int* kr = keys + (size_t)(v / pad) * pad;
      const int q = __ldg(keys + v) + dx * (1 << (2 * kAxisBits)) +
                    (tid ? 1 : -1) * (2 * (1 << kAxisBits) + 2);
      int b = 0;
      for (int len = pad; len > 1; len -= len >> 1)
        if (__ldg(kr + b + (len >> 1)) < q) b += len >> 1;
      pos = (v / pad) * pad + b + (__ldg(kr + b) < q);
    }
    stretch[tid] = pos;
  }
  // im2col columns 200 .. 207 (the last unit's missing 26th offset): zeros
  for (int i = tid; i < 2 * STEM_M; i += STEM_THREADS)
    *reinterpret_cast<uint4*>(as0 + i * STEM_LDA + STEM_G * 8) =
        make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int P0 = stretch[0], P1 = stretch[1];
  int sl = 0;
  while ((P1 - P0 + (1 << sl) - 1) >> sl > STEM_SAMPLES) ++sl;
  const int T = (P1 - P0 + (1 << sl) - 1) >> sl;
  for (int i = tid; i < T; i += STEM_THREADS)
    samp[i] = __ldg(keys + P0 + ((size_t)i << sl));
  __syncthreads();            // the samples before any search reads them

  // the matches of the block's tile j into slot j % 2: per item the first
  // entry p and the hit mask of dz -2..2
  auto search = [&](int j) {
    if (j >= n_my) return;
    const int row0 = (t0 + j) * STEM_M;
    // per item: q (-1: nothing can match), the key's z, its scene's row
    // end, and the lower bound's range [a, hi]: searched first over the m
    // samples sj .. of its scene in the stretch, then over keys
    int q[NS], zf[NS], end[NS], a[NS], m[NS], sj[NS], hi[NS];
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      const int it = tid + t * STEM_THREADS, r = it % STEM_M;
      const int dy = it / STEM_M - 2, v = row0 + r;
      q[t] = -1;
      zf[t] = end[t] = a[t] = m[t] = sj[t] = hi[t] = 0;
      if (it < STEM_ITEMS && v < n) {
        const int key = __ldg(keys + v);
        const int xf = key >> (2 * kAxisBits);
        const int yf = (key >> kAxisBits) & (kAxisMax - 1);
        zf[t] = key & (kAxisMax - 1);
        if (key < kSentKey && xf + dx >= 0 && xf + dx < kAxisMax &&
            yf + dy >= 0 && yf + dy < kAxisMax) {
          q[t] = key + dx * (1 << (2 * kAxisBits)) + dy * (1 << kAxisBits) +
                 max(-2, -zf[t]);
          const int rb = (v / pad) * pad;
          end[t] = rb + pad;
          a[t] = max(P0, rb);                 // the lower bound is in
          hi[t] = min(P1, rb + pad);          // [a, hi]
          sj[t] = (a[t] - P0 + (1 << sl) - 1) >> sl;
          m[t] = hi[t] > a[t] ? max(0, ((hi[t] - 1 - P0) >> sl) + 1 - sj[t])
                              : 0;
        }
      }
    }
    // the last sample < q (index sb), shared memory
    int sb[NS], cnt[NS];
#pragma unroll
    for (int t = 0; t < NS; ++t) sb[t] = 0, cnt[t] = m[t];
    for (int len = T; len > 1; len -= len >> 1) {
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        if (q[t] < 0 || cnt[t] <= 1) continue;
        const int half = cnt[t] >> 1;
        if (samp[sj[t] + sb[t] + half] < q[t]) sb[t] += half;
        cnt[t] -= half;
      }
    }
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      if (q[t] < 0) continue;
      if (m[t] > 0 && samp[sj[t] + sb[t]] < q[t]) {
        const int s = P0 + ((sj[t] + sb[t]) << sl);
        a[t] = s + 1;
        cnt[t] = min(s + (1 << sl), hi[t]) - a[t];
      } else {
        cnt[t] = (m[t] > 0 ? P0 + (sj[t] << sl) : hi[t]) - a[t];
      }
    }
    // the lower bound among the < 2^sl keys left, device memory
    for (int len = 1 << sl; len > 1; len -= len >> 1) {
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        if (q[t] < 0 || cnt[t] <= 1) continue;
        const int half = cnt[t] >> 1;
        if (__ldg(keys + a[t] + half) < q[t]) a[t] += half;
        cnt[t] -= half;
      }
    }
#pragma unroll
    for (int t = 0; t < NS; ++t) {
      const int it = tid + t * STEM_THREADS;
      if (it >= STEM_ITEMS) continue;
      int p = 0, mask = 0;
      if (q[t] >= 0) {
        p = a[t] + (cnt[t] >= 1 && __ldg(keys + a[t]) < q[t]);
        const int zlo = max(-2, -zf[t]), zhi = min(2, kAxisMax - 1 - zf[t]);
        // entry p + e matches dz = zlo + (key - q) where that is in range;
        // the hits are entries p, p + 1, ... in dz order
#pragma unroll
        for (int e = 0; e < 5; ++e) {
          const int d = p + e < end[t] ? __ldg(keys + p + e) - q[t] : -1;
          if (d >= 0 && d <= zhi - zlo) mask |= 1 << (zlo + d + 2);
        }
      }
      mp0[(j & 1) * STEM_ITEMS + it] = p;
      mm0[(j & 1) * STEM_ITEMS + it] = static_cast<unsigned char>(mask);
    }
  };

  // tile j's im2col into stage j % 2 from its matches: the k-th hit of an
  // item is entry p + k; zeros for a miss
  auto gather = [&](int j) {
    if (j >= n_my) return;
    __nv_bfloat16* as = as0 + (j & 1) * STEM_M * STEM_LDA;
    for (int it = tid; it < STEM_ITEMS; it += STEM_THREADS) {
      const int p = mp0[(j & 1) * STEM_ITEMS + it];
      const int mask = mm0[(j & 1) * STEM_ITEMS + it];
      __nv_bfloat16* dst = as + (it % STEM_M) * STEM_LDA + (it / STEM_M) * 5 * 8;
#pragma unroll
      for (int u = 0; u < 5; ++u) {
        const bool hit = (mask >> u) & 1;
        const int src = p + __popc(mask & ((1 << u) - 1));
        hopper::cp_async16(dst + u * 8, hit ? x + (size_t)src * 8 : x,
                           hit ? 16 : 0);
      }
    }
  };

  // tile j's g: thread t < 64 * GCH holds 8 values of row t / GCH in
  // registers (zeros for a SENT row or a row past n), then stores them as
  // bf16 into stage j % 2
  const bool g_thread = tid < STEM_M * GCH;
  const int g_row = tid / GCH, g_col = (tid % GCH) * 8;
  float4 gf[2];
  uint4 gb;
  auto load_g = [&](int j) {
    gf[0] = gf[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    gb = make_uint4(0, 0, 0, 0);
    if (!g_thread || j >= n_my) return;
    const int v = (t0 + j) * STEM_M + g_row;
    if (v >= n || __ldg(keys + v) >= kSentKey) return;
    const GT* src = gr + (size_t)v * NO + g_col;
    if constexpr (sizeof(GT) == 4) {
      gf[0] = __ldg(reinterpret_cast<const float4*>(src));
      gf[1] = __ldg(reinterpret_cast<const float4*>(src) + 1);
    } else {
      gb = __ldg(reinterpret_cast<const uint4*>(src));
    }
  };
  auto store_g = [&](int j) {
    if (!g_thread || j >= n_my) return;
    uint4 val = gb;
    if constexpr (sizeof(GT) == 4) {
      const __nv_bfloat162 h0 = __float22bfloat162_rn(make_float2(gf[0].x, gf[0].y));
      const __nv_bfloat162 h1 = __float22bfloat162_rn(make_float2(gf[0].z, gf[0].w));
      const __nv_bfloat162 h2 = __float22bfloat162_rn(make_float2(gf[1].x, gf[1].y));
      const __nv_bfloat162 h3 = __float22bfloat162_rn(make_float2(gf[1].z, gf[1].w));
      val = make_uint4(*reinterpret_cast<const uint32_t*>(&h0),
                       *reinterpret_cast<const uint32_t*>(&h1),
                       *reinterpret_cast<const uint32_t*>(&h2),
                       *reinterpret_cast<const uint32_t*>(&h3));
    }
    *reinterpret_cast<uint4*>(gs0 + (j & 1) * STEM_M * LDG + g_row * LDG +
                              g_col) = val;
  };

  // this warp's units: im2col columns 16 um .. (offsets 2 um, 2 um + 1),
  // outputs 16 nb ..
  int u_m[UPW], u_n[UPW];
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    const int unit = warp + 8 * u;
    u_m[u] = unit < UNITS ? unit / NBS : -1;
    u_n[u] = (unit % NBS) * 16;
  }
  const int a_off = ((lane & 7) + ((lane >> 4) & 1) * 8) * STEM_LDA +
                    ((lane >> 3) & 1) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDG +
                    ((lane >> 4) & 1) * 8;
  float acc[UPW][2][4];
#pragma unroll
  for (int u = 0; u < UPW; ++u)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.0f;

  auto multiply = [&](int i) {
    const __nv_bfloat16* as = as0 + (i & 1) * STEM_M * STEM_LDA + a_off;
    const __nv_bfloat16* gs = gs0 + (i & 1) * STEM_M * LDG + b_off;
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      if (u_m[u] < 0) continue;
#pragma unroll
      for (int ks = 0; ks < STEM_M / 16; ++ks) {
        uint32_t af[4], bf[4];
        ldsm_x4_trans(af, as + u_m[u] * 16 + ks * 16 * STEM_LDA);
        ldsm_x4_trans(bf, gs + u_n[u] + ks * 16 * LDG);
        mma16816(acc[u][0], af, bf[0], bf[1]);
        mma16816(acc[u][1], af, bf[2], bf[3]);
      }
    }
  };

  search(0);
  search(1);
  load_g(0);
  __syncthreads();            // the matches of tiles 0 and 1
  gather(0);
  hopper::cp_async_commit();
  store_g(0);
  for (int i = 0; i < n_my; ++i) {
    hopper::cp_async_wait(0);
    __syncthreads();          // tile i landed, tile i + 1's matches written,
                              // tile i - 1's products and gathers done
    gather(i + 1);
    hopper::cp_async_commit();
    load_g(i + 1);
    search(i + 2);
    multiply(i);
    store_g(i + 1);
  }

  // D row m = (lane >> 2) + 8 h of a unit is offset 2 um + h, channel
  // lane >> 2; column 16 nb + 8 j + 2 (lane & 3) (+1)
  const int c = lane >> 2;
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    if (u_m[u] < 0 || c >= cin) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = 2 * u_m[u] + h;
      if (l >= STEM_G) continue;
      float* dst = part + (((size_t)blockIdx.y * 125 + blockIdx.x * STEM_G + l) *
                           cin + c) * NO + u_n[u] + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<float2*>(dst + j * 8) =
            make_float2(acc[u][j][2 * h], acc[u][j][2 * h + 1]);
    }
  }
}

template <int NO, typename GT>
int launch_stem_dw(const void* x, const void* keys, const void* g, void* part,
                   int n, int pad, int cin, int& slices, cudaStream_t stream) {
  constexpr auto kernel = key_conv_stem_dw_kernel<NO, GT>;
  const int bytes = stem_dw_bytes(NO);
  int rc = conv_tile::allow_smem<kernel>(bytes);
  if (rc) return rc;
  // one wave: as many slices as the SMs hold blocks of the 5 dx groups
  int per_sm = 1, sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, STEM_THREADS,
                                                bytes);
  const int n_tiles = (n + STEM_M - 1) / STEM_M;
  int S = (per_sm > 0 ? per_sm : 1) * sms / 5;
  if (S > slices) S = slices;
  if (S > n_tiles) S = n_tiles;
  slices = S < 1 ? 1 : S;
  kernel<<<dim3(5, slices), STEM_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(keys),
      static_cast<const GT*>(g), static_cast<float*>(part), n, pad, cin);
  return static_cast<int>(cudaGetLastError());
}

// The stem dw's pass 2: out[i] = sum over the S slices of part[s][i], in
// slice order.
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

}  // namespace

extern "C" {

// The three modes of key_conv: same-level (ks 3, lo -1, sign 1, guard 1),
// down (ks 2, lo 0, sign 1, guard 0), up (ks 2, lo 0, sign -1, guard 0).
// x (B*pad_in, cin) bf16; keys_in (B, pad_in) i32 sorted, SENT-padded;
// keys_out (B*pad_out,) i32; w (ks^3, cin, cout) bf16; wp scratch of
// ks^3 * cout * n_ch * kc bf16 (conv_tile::chunks), the packed w; cin % 8
// == 0 (x and w zero-padded by the caller); out
// (B*pad_out, cout) f32 (out_bf16 = 0) or bf16. Returns the CUDA error code
// of the launches.
int b2m_key_conv(const void* x, const void* keys_in, const void* keys_out,
                 const void* w, void* wp, void* out, int B, int pad_in,
                 int pad_out, int cin, int cout, int ks, int lo, int sign,
                 int scale, int guard, int out_bf16, void* stream) {
  const Geom g{B, pad_in, pad_out, cin, cout, ks, lo, sign, scale, guard};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return dispatch<__nv_bfloat16>(x, keys_in, keys_out, w, wp, out, g, s);
  return dispatch<float>(x, keys_in, keys_out, w, wp, out, g, s);
}

// The 5^3 stem: input space == output space, f32 out; wp as b2m_key_conv.
int b2m_key_conv_stem(const void* x, const void* keys, const void* w,
                      void* wp, void* out, int B, int pad, int cin, int cout,
                      void* stream) {
  const Geom g{B, pad, pad, cin, cout, 5, -2, 1, 1, 1};
  return dispatch<float>(x, keys, keys, w, wp, out, g,
                         static_cast<cudaStream_t>(stream));
}

// The scratch of the dw below, on the current device: out[9] = {total
// ints, the work items' cap, n_pad, n_chunks, and the offsets in ints of
// the pairs, table, counts and meta} (csrc/dw_plan.cuh DwScratch).
int b2m_key_conv_dw_scratch(int n_out, int ks, int cin, int cout,
                            long long* out) {
  if (ks < 1 || ks * ks * ks > DW_KMAX || n_out < 0 || cin < 1 || cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DwScratch(n_out, ks * ks * ks, cin, cout, sm_count()).write(out);
  return 0;
}

// dw of the three key_conv modes (the same Geom as b2m_key_conv): x
// (B*pad_in, cin) bf16, cin % 8 == 0; g (B*pad_out, cout) bf16, cout % 16
// == 0; dw (ks^3, cin, cout) f32; scratch of b2m_key_conv_dw_scratch's
// total ints.
int b2m_key_conv_dw(const void* x, const void* keys_in, const void* keys_out,
                    const void* g, void* dw, void* scratch, int B, int pad_in,
                    int pad_out, int cin, int cout, int ks, int lo, int sign,
                    int scale, int guard, void* stream) {
  const Geom geo{B, pad_in, pad_out, cin, cout, ks, lo, sign, scale, guard};
  return dw_entry({x, keys_in, keys_out, g, dw, scratch, geo}, true,
                  static_cast<cudaStream_t>(stream));
}

// The pair lists of that dw alone (passes 0-2), into the same scratch: per
// offset k its (input row, output row) pairs from int2 k * n_pad, in
// output-row order; meta as the multiply reads it.
int b2m_key_conv_dw_pairs(const void* keys_in, const void* keys_out,
                          void* scratch, int B, int pad_in, int pad_out,
                          int cin, int cout, int ks, int lo, int sign,
                          int scale, int guard, void* stream) {
  const Geom geo{B, pad_in, pad_out, cin, cout, ks, lo, sign, scale, guard};
  return dw_entry({nullptr, keys_in, keys_out, nullptr, nullptr, scratch, geo},
                  false, static_cast<cudaStream_t>(stream));
}

// dw of the 5^3 stem: x (B*pad, 8) bf16, the cin <= 8 channels zero-padded
// to 8; keys (B, pad) i32 sorted, SENT-padded; g (B*pad, cout) f32 (g_bf16
// = 0) or bf16, cout 16 or 32, rounded to bf16 in the kernel; part (slices,
// 125, cin, cout) f32 scratch; dw (125, cin, cout) f32. The launch uses at
// most `slices` row slices (as many as one wave of blocks holds).
int b2m_key_conv_stem_dw(const void* x, const void* keys, const void* g,
                         void* part, void* dw, int B, int pad, int cin,
                         int cout, int g_bf16, int slices, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin < 1 || cin > 8 || (cout != 16 && cout != 32) || slices < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = (size_t)125 * cin * cout;
  if (B * pad == 0) {
    const int rc = static_cast<int>(cudaMemsetAsync(dw, 0, n * sizeof(float), s));
    return rc ? rc : static_cast<int>(cudaGetLastError());
  }
  int rc;
  if (cout == 32)
    rc = g_bf16 ? launch_stem_dw<32, __nv_bfloat16>(x, keys, g, part, B * pad, pad, cin, slices, s)
                : launch_stem_dw<32, float>(x, keys, g, part, B * pad, pad, cin, slices, s);
  else
    rc = g_bf16 ? launch_stem_dw<16, __nv_bfloat16>(x, keys, g, part, B * pad, pad, cin, slices, s)
                : launch_stem_dw<16, float>(x, keys, g, part, B * pad, pad, cin, slices, s);
  if (rc) return rc;
  return sum_slices(static_cast<const float*>(part), static_cast<float*>(dw),
                    n, slices, s);
}

}  // extern "C"
