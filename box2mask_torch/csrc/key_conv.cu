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
// through its sequential grid; here blocks run in parallel. Pass 0 searches
// every (offset, output row) pair at once into an int32 match table. Pass 1:
// a block owns (row slice, group of G offsets, CI input channels, NT output
// channels) and walks its row tiles (64 rows; tiles s, s + S, ...) through a
// ring of 2-4 stages: per tile one g tile and the G matched x tiles arrive by
// cp.async (zeros for a miss, and for g rows no offset of the group matched)
// while the previous tile is multiplied, and the tile's table rows arrive by
// cp.async one ring turn ahead of the gathers that need them. Each staged g
// tile serves G offsets. The 8 warps share the (offset, 16 input channels,
// NB output channels) units of the group; x^T g runs as mma.sync m16n8k16
// with both operands loaded by ldmatrix.trans, f32 accumulators in
// registers; a unit whose offset matched no row of the tile is skipped.
// Each block writes its slab to partials[s]; pass 2 adds the S partials in
// slice order. S is one wave of blocks (the occupancy API's count), which
// keeps the partials small. No atomics: the result is the same bit for bit
// from run to run.
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
constexpr int DW_M = 64;          // rows per dw tile (the product's depth)
constexpr int DW_THREADS = 256;   // 8 warps
constexpr int DW_WARPS = DW_THREADS / 32;

// How a dw launch splits the work; key_conv.py (_dw_slices) mirrors it to
// size the partials. CI input channels and NT output channels per block,
// G offsets sharing each g tile (~48 KB of x tiles per stage at most), and
// per warp units of CW input x NB output channels of one offset: a 32 x 32
// unit loads two A and two B fragments per eight products.
struct DwPlan {
  int CI, n_ci, NT, NB, CW, G, n_kg, upo, UPW;
  DwPlan(int K, int cin, int cout) {
    CI = cin <= 128 ? (cin + 15) / 16 * 16 : 128;
    n_ci = (cin + CI - 1) / CI;
    NT = cout % 128 == 0 ? 128 : cout % 96 == 0 ? 96 : cout % 64 == 0 ? 64
         : cout % 32 == 0 ? 32 : 16;
    NB = NT % 32 == 0 ? 32 : 16;
    CW = CI % 32 == 0 ? 32 : 16;
    upo = (CI / CW) * (NT / NB);
    // at most 8 units per warp and 128 accumulator registers per thread
    const int per_warp = 4096 / (CW * NB) < 8 ? 4096 / (CW * NB) : 8;
    G = DW_WARPS * per_warp / upo;
    const int g_smem = 49152 / (2 * DW_M * (CI + 8));
    if (G > g_smem) G = g_smem;
    if (G > K) G = K;
    if (G < 1) G = 1;
    n_kg = (K + G - 1) / G;
    UPW = (G * upo + DW_WARPS - 1) / DW_WARPS;
  }
  int bytes(int stages) const {
    return stages * 2 * DW_M * ((NT + 8) + G * (CI + 8)) +
           2 * stages * G * DW_M * 4;
  }
};

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

// Pass 1 of dw for the three _kernel modes. Block (kg, s, z): offsets
// kg * G .. + G, input channels c0 .. c0 + CI and output channels n0 .. n0 +
// NT (z enumerates the chunks), over row tiles s, s + S, ...; matches from
// the table (K rows of n_pad entries, -1 past n_out). Writes the block's
// slab of the partial sum to part[s][k] (a (cin, cout) f32 block per slice
// and offset).
template <int NB, int CW, int UPW>
__global__ void __launch_bounds__(DW_THREADS)
key_conv_dw_kernel(const __nv_bfloat16* __restrict__ x,
                   const int* __restrict__ table,
                   const __nv_bfloat16* __restrict__ gr,
                   float* __restrict__ part, Geom g, int n_pad, int G, int CI,
                   int NT, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K = g.ks * g.ks * g.ks, cin = g.cin, cout = g.cout;
  const int n_tiles = (g.B * g.pad_out + DW_M - 1) / DW_M;
  const int k0 = blockIdx.x * G, Gv = min(G, K - k0);
  const int s0 = blockIdx.y, S = gridDim.y;
  const int n_ci = (cin + CI - 1) / CI;
  const int c0 = (blockIdx.z % n_ci) * CI, n0 = (blockIdx.z / n_ci) * NT;
  const int LDX = CI + 8, LDG = NT + 8;
  const int nbs = NT / NB, upo = (CI / CW) * nbs;
  const int n_my = s0 < n_tiles ? (n_tiles - s0 + S - 1) / S : 0;

  __nv_bfloat16* gs0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs0 = gs0 + stages * DW_M * LDG;
  int* ix0 = reinterpret_cast<int*>(xs0 + stages * G * DW_M * LDX);
  auto slot = [&](int i) { return ix0 + (i % (2 * stages)) * G * DW_M; };

  // the table rows of tile j (the block's j-th), one ring turn ahead
  auto load_idx = [&](int j) {
    if (j >= n_my) return;
    int* d = slot(j);
    const int row0 = (s0 + j * S) * DW_M;
    for (int v = tid; v < Gv * (DW_M / 4); v += DW_THREADS) {
      const int kk = v >> 4, q = v & 15;            // DW_M / 4 = 16
      hopper::cp_async16(d + kk * DW_M + q * 4,
                         table + (size_t)(k0 + kk) * n_pad + row0 + q * 4, 16);
    }
  };
  // tile i's g rows (zeros where no offset of the group matched) and its
  // G matched x tiles into stage i % stages. Thread t moves row
  // (t / 2) % 64, chunks (t % 2) + 2 (t / 128) + 4j: a warp reads pairs of
  // 16-byte chunks of 16 rows, full 32-byte sectors.
  const int lr = (tid >> 1) & (DW_M - 1), lc = (tid & 1) + 2 * (tid >> 7);
  const int gv = NT / 8, xv = CI / 8;
  auto issue = [&](int i) {
    load_idx(i + stages - 1);
    if (i >= n_my) return;
    const int st = i % stages, row0 = (s0 + i * S) * DW_M;
    const int* ix = slot(i) + lr;
    bool any = false;
    for (int kk = 0; kk < Gv; ++kk) any |= ix[kk * DW_M] >= 0;
    __nv_bfloat16* gs = gs0 + st * DW_M * LDG + lr * LDG;
    const __nv_bfloat16* gsrc = gr + (size_t)(row0 + lr) * cout + n0;
    for (int cv = lc; cv < gv; cv += 4)
      hopper::cp_async16(gs + cv * 8, any ? gsrc + cv * 8 : gr,
                         any ? 16 : 0);
    __nv_bfloat16* xs = xs0 + st * G * DW_M * LDX + lr * LDX;
    for (int kk = 0; kk < Gv; ++kk) {
      const int src = ix[kk * DW_M];
      for (int cv = lc; cv < xv; cv += 4)
        conv_tile::gather8(xs + kk * DW_M * LDX + cv * 8, x, src, cin,
                           c0 + cv * 8);
    }
  };

  // this warp's units: (offset kk, CW input channels, NB outputs)
  int u_kk[UPW], u_x[UPW], u_g[UPW];
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    const int unit = warp + DW_WARPS * u;
    u_kk[u] = unit < Gv * upo ? unit / upo : -1;
    u_x[u] = u_kk[u] * DW_M * LDX + ((unit % upo) / nbs) * CW;
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

  for (int m = 0; m < stages - 1 && m < n_my; ++m) {
    int* d = slot(m);
    const int row0 = (s0 + m * S) * DW_M;
    for (int v = tid; v < Gv * DW_M; v += DW_THREADS)
      d[v] = __ldg(table + (size_t)(k0 + v / DW_M) * n_pad + row0 + v % DW_M);
  }
  __syncthreads();
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
    const int* ix = slot(i);
    const __nv_bfloat16* gs = gs0 + st * DW_M * LDG + b_off;
    const __nv_bfloat16* xs = xs0 + st * G * DW_M * LDX + a_off;
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      if (u_kk[u] < 0) continue;
      const int* h = ix + u_kk[u] * DW_M;
      if (!__any_sync(0xffffffffu, h[lane] >= 0 || h[lane + 32] >= 0))
        continue;
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

#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    if (u_kk[u] < 0) continue;
    const int unit = warp + DW_WARPS * u;
    const int cb = (unit % upo) / nbs, nb = unit % nbs;
    float* dst = part + ((size_t)s0 * K + k0 + u_kk[u]) * cin * cout;
#pragma unroll
    for (int c2 = 0; c2 < CW / 16; ++c2)
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + cb * CW + c2 * 16 + (lane >> 2) + 8 * h;
          const int n = n0 + nb * NB + j * 8 + (lane & 3) * 2;
          if (c < cin)
            *reinterpret_cast<float2*>(dst + (size_t)c * cout + n) =
                make_float2(acc[u][c2][j][2 * h], acc[u][c2][j][2 * h + 1]);
        }
  }
}

template <int NB, int CW, int UPW>
int launch_dw_k(const void* x, const void* table, const void* gr, void* part,
                const Geom& g, int n_pad, const DwPlan& p, int& slices,
                cudaStream_t stream) {
  constexpr auto kernel = key_conv_dw_kernel<NB, CW, UPW>;
  // as many blocks per SM as the registers allow (up to 4), then as many
  // stages (2..4) as fit beside them
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
  // one wave: as many slices as the SMs hold blocks, within the capacity
  // of the partials (slices) and one slice per tile
  int per_sm = 1, sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DW_THREADS,
                                                bytes);
  const int per_slice = p.n_kg * p.n_ci * (g.cout / p.NT);
  const int n_tiles = (g.B * g.pad_out + DW_M - 1) / DW_M;
  int S = (per_sm > 0 ? per_sm : 1) * sms / per_slice;
  if (S > slices) S = slices;
  if (S > n_tiles) S = n_tiles;
  slices = S < 1 ? 1 : S;
  dim3 grid(p.n_kg, slices, p.n_ci * (g.cout / p.NT));
  kernel<<<grid, DW_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(table),
      static_cast<const __nv_bfloat16*>(gr), static_cast<float*>(part), g,
      n_pad, p.G, p.CI, p.NT, stages);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for the plan's unit shape (NB, CW) and units per warp
template <int NB, int CW>
int launch_dw_u(const void* x, const void* table, const void* gr, void* part,
                const Geom& g, int n_pad, const DwPlan& p, int& slices,
                cudaStream_t s) {
  switch (p.UPW) {
    case 1: return launch_dw_k<NB, CW, 1>(x, table, gr, part, g, n_pad, p, slices, s);
    case 2: return launch_dw_k<NB, CW, 2>(x, table, gr, part, g, n_pad, p, slices, s);
    case 3: return launch_dw_k<NB, CW, 3>(x, table, gr, part, g, n_pad, p, slices, s);
    case 4: return launch_dw_k<NB, CW, 4>(x, table, gr, part, g, n_pad, p, slices, s);
  }
  if constexpr (NB * CW <= 512) {       // 32 x 32 units: at most 4
    switch (p.UPW) {
      case 5: return launch_dw_k<NB, CW, 5>(x, table, gr, part, g, n_pad, p, slices, s);
      case 6: return launch_dw_k<NB, CW, 6>(x, table, gr, part, g, n_pad, p, slices, s);
      case 7: return launch_dw_k<NB, CW, 7>(x, table, gr, part, g, n_pad, p, slices, s);
      case 8: return launch_dw_k<NB, CW, 8>(x, table, gr, part, g, n_pad, p, slices, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_dw(const void* x, const void* table, const void* gr, void* part,
              const Geom& g, int n_pad, const DwPlan& p, int& slices,
              cudaStream_t s) {
  if (p.NB == 32 && p.CW == 32) return launch_dw_u<32, 32>(x, table, gr, part, g, n_pad, p, slices, s);
  if (p.NB == 32) return launch_dw_u<32, 16>(x, table, gr, part, g, n_pad, p, slices, s);
  if (p.CW == 32) return launch_dw_u<16, 32>(x, table, gr, part, g, n_pad, p, slices, s);
  return launch_dw_u<16, 16>(x, table, gr, part, g, n_pad, p, slices, s);
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

// The matched input row (or -1) of every output row at every offset:
// table[k * n_pad + v] = match(keys_out[v], k), -1 for v >= n_out. One
// search per thread, all in flight at once, so the dw kernels read their
// matches with one coalesced load per tile.
__global__ void match_table_kernel(const int* __restrict__ keys_in,
                                   const int* __restrict__ keys_out,
                                   int* __restrict__ table, Geom g,
                                   int n_pad) {
  const int n_out = g.B * g.pad_out;
  const size_t n = (size_t)g.ks * g.ks * g.ks * n_pad;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(i / n_pad), v = (int)(i % n_pad);
    table[i] = v < n_out
        ? match(g, keys_in, __ldg(keys_out + v), v / g.pad_out, k) : -1;
  }
}

int match_table(const void* keys_in, const void* keys_out, void* table,
                const Geom& g, int n_pad, cudaStream_t stream) {
  const size_t n = (size_t)g.ks * g.ks * g.ks * n_pad;
  const size_t blocks = (n + 255) / 256;
  match_table_kernel<<<(int)(blocks < 132 * 64 ? blocks : 132 * 64), 256, 0,
                       stream>>>(static_cast<const int*>(keys_in),
                                 static_cast<const int*>(keys_out),
                                 static_cast<int*>(table), g, n_pad);
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

int table_stride(int n_out) { return (n_out + DW_M - 1) / DW_M * DW_M; }

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

// dw of the three key_conv modes (the same Geom as b2m_key_conv): x
// (B*pad_in, cin) bf16, cin % 8 == 0; g (B*pad_out, cout) bf16; part (slices, ks^3, cin,
// cout) f32 and table (ks^3, n_pad) i32 scratch, n_pad = B*pad_out rounded
// up to 64; dw (ks^3, cin, cout) f32. cout % 16 == 0. The launch uses at
// most `slices` row slices (as many as one wave of blocks holds).
int b2m_key_conv_dw(const void* x, const void* keys_in, const void* keys_out,
                    const void* g, void* part, void* dw, void* table, int B,
                    int pad_in, int pad_out, int cin, int cout, int ks,
                    int lo, int sign, int scale, int guard, int slices,
                    void* stream) {
  const Geom geo{B, pad_in, pad_out, cin, cout, ks, lo, sign, scale, guard};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slices < 1 || cout % 16 || cin % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int K = ks * ks * ks;
  const size_t n = (size_t)K * cin * cout;
  int rc;
  if (B * pad_out == 0 || n == 0) {
    rc = static_cast<int>(cudaMemsetAsync(dw, 0, n * sizeof(float), s));
    return rc ? rc : static_cast<int>(cudaGetLastError());
  }
  const int n_pad = table_stride(B * pad_out);
  rc = match_table(keys_in, keys_out, table, geo, n_pad, s);
  if (rc) return rc;
  const DwPlan p(K, cin, cout);
  rc = launch_dw(x, table, g, part, geo, n_pad, p, slices, s);
  if (rc) return rc;
  return sum_slices(static_cast<const float*>(part), static_cast<float*>(dw),
                    n, slices, s);
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
