// The output tile of the gather-GEMM sparse convolutions, shared by
// csrc/key_conv.cu (rows matched by a key search) and csrc/nmap_conv.cu
// (rows read from a neighbor map):
//
//   out[v] = sum_k bf16(x[src_k(v)]) @ bf16(w[k])      (f32 accumulation)
//
// for the M = 128 output rows and NT output channels of one block (two
// warpgroups of 64 rows), where src_k(v) is the input row matched at offset
// k, or -1 (adds 0).
//
// Design for Hopper:
//  1. Matches up front. The block first finds the matches of all its rows at
//     all K offsets (the Matches functor: independent searches, or one
//     coalesced read of the tile's map rows) into shared memory, then the
//     list of live offsets, those with at least one hit in the tile. The
//     product loop runs over (live offset, cin chunk) items only.
//  2. A ring of 2-4 stages in dynamic shared memory. A stage holds one item
//     (or, where cin is under 64, as many items as make 64 channels, so
//     that the stem's 125 offsets take 32 ring steps and not 125): the
//     gathered x rows (cp.async, 16 bytes per copy with zero-fill for a
//     miss and past cin; cin % 8 == 0, narrower x zero-padded) and the w[k]
//     slabs, bulk copies completing on the stage's mbarrier. w is packed
//     once per launch (pack_w_kernel) into the exact image the tensor cores
//     read, cin zero-padded to the chunk. The loads of the next stages - 1
//     steps are in flight while the current one is multiplied. The host
//     picks as many resident blocks per SM as the registers allow (up to 4)
//     before more stages: other blocks' searches and gathers cover a
//     block's own waits better than a deeper ring did at the small sites.
//  3. wgmma.mma_async m64nNTk16, bf16 operands from shared memory (both
//     K-major, 8x8 core matrices, no swizzle), f32 accumulators in
//     registers across all items.
//  4. The epilogue pairs lanes so that each writes 16 bytes of f32 (or 8
//     bytes of bf16, rounded to nearest even) per store; rows >= n_out are
//     masked; a row with no hit (padding, SENT key) comes out exactly 0.
// M = 128: each w slab brought in serves 128 rows; NT is the whole cout up
// to 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace conv_tile {

constexpr int M = 128;           // output rows per block
constexpr int THREADS = 256;     // two warpgroups, 64 rows each
constexpr int MS = M + 1;        // row stride of the match table in smem
constexpr int MAX_KC = 128;      // widest cin chunk of one stage
constexpr int STAGE_C = 64;      // channels a stage gathers where cin < 64
constexpr int SMEM_MAX = 227 * 1024;    // one block
constexpr int SMEM_SM = 228 * 1024;     // all blocks of an SM

// cin in n_ch chunks of kc channels (kc % 16 == 0, n_ch * kc >= cin);
// key_conv.py / pallas_conv.py size the packed w with the same rule
__host__ __device__ inline void chunks(int cin, int& n_ch, int& kc) {
  const int kp = (cin + 15) / 16 * 16;
  n_ch = (kp + MAX_KC - 1) / MAX_KC;
  kc = ((kp + n_ch - 1) / n_ch + 15) / 16 * 16;
}

// element offset of (row r, channel c) in a K-major tile of kc channels
// made of 8x8 core matrices (128 contiguous bytes each)
__host__ __device__ __forceinline__ int core_off(int r, int c, int kc) {
  return ((r >> 3) * (kc >> 3) + (c >> 3)) * 64 + (r & 7) * 8 + (c & 7);
}

// Shared memory of one block: stages x (ips x tiles of x, ips x w slabs),
// the match table, the live offsets, the mbarriers and M ints of scratch for
// the functor. A stage holds ips items (ips > 1 only where cin fits one
// chunk narrower than the stage's channel capacity).
struct Layout {
  int stages, ips, kc, n_ch, xs_bytes, ws_bytes, mt_off, live_off, bar_off,
      aux_off, bytes;
  __host__ __device__ Layout(int cin, int NT, int K, int st, int ip)
      : stages(st), ips(ip) {
    chunks(cin, n_ch, kc);
    xs_bytes = ip * M * kc * 2;
    ws_bytes = ip * NT * kc * 2;
    mt_off = st * (xs_bytes + ws_bytes);
    live_off = mt_off + K * MS * 4;
    bar_off = (live_off + (2 * K + 1) * 4 + 7) / 8 * 8;
    aux_off = bar_off + st * 8;
    bytes = aux_off + M * 4;
  }
};

// Registers per thread of a kernel (read once).
template <auto Kernel>
int kernel_regs() {
  static int regs = 0;
  if (!regs) {
    cudaFuncAttributes a;
    regs = cudaFuncGetAttributes(&a, Kernel) == cudaSuccess ? a.numRegs : 255;
  }
  return regs;
}

// Items per stage and stage count. A stage holds up to 64 channels (ips
// chunks of kc; one chunk where cin is wider). Then as many blocks per SM
// as the registers allow (up to 4: more tiles searching and gathering at
// once hide more latency), and as many stages (2..4) as fit beside them;
// stages 0 if not even 2 fit one block.
inline void pick_stages(int cin, int NT, int K, int regs, int& stages,
                        int& ips) {
  int n_ch, kc;
  chunks(cin, n_ch, kc);
  ips = n_ch == 1 && kc < STAGE_C ? STAGE_C / kc : 1;
  stages = 0;
  const int by_regs = 65536 / (((regs + 7) / 8 * 8) * THREADS);
  for (int b = by_regs < 4 ? by_regs : 4; b >= 1 && !stages; --b)
    for (int s = 4; s >= 2 && !stages; --s)
      if (b * (Layout(cin, NT, K, s, ips).bytes + 1024) <= SMEM_SM) stages = s;
}

__device__ __forceinline__ float to_out(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// 8 channels c .. c + 7 of x row `src` into 16 bytes of shared memory by
// one cp.async, zeros for src < 0 and past cin (cin % 8 == 0: the wrappers
// zero-pad narrower inputs).
__device__ __forceinline__ void gather8(__nv_bfloat16* dst,
                                        const __nv_bfloat16* __restrict__ x,
                                        int src, int cin, int c) {
  const bool ok = src >= 0 && c < cin;
  hopper::cp_async16(dst, ok ? x + (size_t)src * cin + c : x, ok ? 16 : 0);
}

// w (K, cin, cout) -> the stage images: for offset k, output-channel block
// jn (NT wide) and cin chunk ch, NT x kc K-major core matrices (w^T), cin
// zero-padded; slab (k, jn, ch) starts at ((k * cout / NT + jn) * n_ch + ch)
// * NT * kc.
__global__ void pack_w_kernel(const __nv_bfloat16* __restrict__ w,
                              __nv_bfloat16* __restrict__ wp, int K, int cin,
                              int cout, int NT) {
  int n_ch, kc;
  chunks(cin, n_ch, kc);
  const size_t slab = (size_t)NT * kc;
  const size_t n = (size_t)K * cout * n_ch * kc;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t s = i / slab;
    const int e = (int)(i % slab);
    const int core = e >> 6, within = e & 63;
    const int nn = (core / (kc >> 3)) * 8 + (within >> 3);
    const int cc = (core % (kc >> 3)) * 8 + (within & 7);
    const int ch = (int)(s % n_ch);
    const size_t t = s / n_ch;
    const int jn = (int)(t % (cout / NT)), k = (int)(t / (cout / NT));
    const int ci = ch * kc + cc;
    wp[i] = ci < cin ? w[((size_t)k * cin + ci) * cout + jn * NT + nn]
                     : __float2bfloat16_rn(0.0f);
  }
}

inline int pack_w(const void* w, void* wp, int K, int cin, int cout, int NT,
                  cudaStream_t stream) {
  int n_ch, kc;
  chunks(cin, n_ch, kc);
  const size_t n = (size_t)K * cout * n_ch * kc;
  const size_t blocks = (n + 255) / 256;
  pack_w_kernel<<<(int)(blocks < 1024 ? blocks : 1024), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wp),
      K, cin, cout, NT);
  return static_cast<int>(cudaGetLastError());
}

// The block's tile of out: rows blockIdx.x * M .. + M, output channels
// blockIdx.y * NT .. + NT. `matches(mt, aux)` is called by all threads and
// fills mt[k * MS + r] with the input row matched by tile row r at offset k,
// or -1 (rows past n_out: -1); aux is M ints of scratch.
template <int NT, typename OutT, typename Matches>
__device__ __forceinline__ void conv_tile(const __nv_bfloat16* __restrict__ x,
                                          const __nv_bfloat16* __restrict__ wp,
                                          OutT* __restrict__ out, int n_out,
                                          int cin, int cout, int K, int stages,
                                          int ips, const Matches& matches) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(cin, NT, K, stages, ips);
  int* mt = reinterpret_cast<int*>(smem + L.mt_off);
  int* live = reinterpret_cast<int*>(smem + L.live_off);
  int* flag = live + K;
  int* n_live_p = flag + K;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  int* aux = reinterpret_cast<int*>(smem + L.aux_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * M, jn = blockIdx.y, n0 = jn * NT;
  const int kc = L.kc, n_ch = L.n_ch, vpr = kc / 8;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(&bars[s], 1);
    hopper::mbar_init_fence();
  }
  matches(mt, aux);
  __syncthreads();
  // live offsets, in offset order
  for (int k = warp; k < K; k += THREADS / 32) {
    bool hit = false;
#pragma unroll
    for (int j = 0; j < M / 32; ++j) hit |= mt[k * MS + lane + 32 * j] >= 0;
    hit = __any_sync(0xffffffffu, hit);
    if (lane == 0) flag[k] = hit;
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int kb = 0; kb < K; kb += 32) {
      const bool f = kb + lane < K && flag[kb + lane];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) live[count + __popc(m & ((1u << lane) - 1))] = kb + lane;
      count += __popc(m);
    }
    if (lane == 0) *n_live_p = count;
  }
  __syncthreads();
  const int n_items = *n_live_p * n_ch;
  const int n_steps = (n_items + ips - 1) / ips;
  const int x_sub = M * kc, w_sub = NT * kc;      // elements per item

  // step j: items j * ips .. (item i: live offset i / n_ch, cin chunk
  // i % n_ch) into stage j % stages
  auto issue = [&](int j) {
    if (j >= n_steps) return;
    const int s = j % stages, i0 = j * ips;
    const int n_sub = min(ips, n_items - i0);
    __nv_bfloat16* xs =
        reinterpret_cast<__nv_bfloat16*>(smem + s * L.xs_bytes);
    for (int sub = 0; sub < n_sub; ++sub) {
      const int k = live[(i0 + sub) / n_ch], ch = (i0 + sub) % n_ch;
      const int* src = mt + k * MS;
      // pairs of 16-byte chunks of 16 rows per warp: full 32-byte sectors
      // from global memory, the fewest shared-memory wavefronts
      for (int v = tid; v < M * vpr; v += THREADS) {
        const int r = (v >> 1) % M, cv = (v & 1) + 2 * ((v >> 1) / M);
        gather8(xs + sub * x_sub + core_off(r, cv * 8, kc), x, src[r], cin,
                ch * kc + cv * 8);
      }
    }
    if (tid == 0) {
      __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(
          smem + stages * L.xs_bytes + s * L.ws_bytes);
      hopper::mbar_expect_tx(&bars[s], n_sub * w_sub * 2);
      for (int sub = 0; sub < n_sub; ++sub) {
        const int k = live[(i0 + sub) / n_ch], ch = (i0 + sub) % n_ch;
        hopper::bulk_copy(
            ws + sub * w_sub,
            wp + (((size_t)k * (cout / NT) + jn) * n_ch + ch) * w_sub,
            w_sub * 2, &bars[s]);
      }
    }
  };

  float acc[NT / 2];
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) acc[j] = 0.0f;
  const int wg = tid >> 7;
  const uint32_t sbo = kc * 16;         // bytes between 8-row groups

  for (int j = 0; j < stages - 1; ++j) {
    issue(j);
    hopper::cp_async_commit();
  }
  for (int j = 0; j < n_steps; ++j) {
    const int s = j % stages;
    hopper::cp_async_wait(stages - 2);  // this thread's copies of step j
    hopper::mbar_wait(&bars[s], (j / stages) & 1);   // its w slabs
    hopper::fence_proxy_async();
    __syncthreads();                    // every copy of step j landed, and
                                        // step j - 1's products are done
    issue(j + stages - 1);              // into the stage step j - 1 used
    hopper::cp_async_commit();

    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(smem + s * L.xs_bytes) +
        wg * 64 * kc;
    const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(
        smem + stages * L.xs_bytes + s * L.ws_bytes);
    const int kpi = kc / 16;            // k16 steps per item
    const int n_k16 = min(ips, n_items - j * ips) * kpi;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    for (int t = 0; t < n_k16; ++t) {
      const int sub = t / kpi, kk = t % kpi;
      hopper::wgmma_bf16<NT>(
          acc, hopper::desc(xs + sub * x_sub + kk * 128, 128, sbo),
          hopper::desc(ws + sub * w_sub + kk * 128, 128, sbo));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    hopper::fence_regs(acc);
  }

  // epilogue: lanes 2q and 2q + 1 swap halves so that each holds 4
  // consecutive columns of one row
  const bool odd = lane & 1;
  const int r = row0 + wg * 64 + (warp & 3) * 16 + (lane >> 2) + (odd ? 8 : 0);
  const int cb = ((lane & 3) >> 1) * 4;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];
    const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    float v[4];
    if (odd) {
      v[0] = r0; v[1] = r1; v[2] = acc[4 * j + 2]; v[3] = acc[4 * j + 3];
    } else {
      v[0] = acc[4 * j]; v[1] = acc[4 * j + 1]; v[2] = r0; v[3] = r1;
    }
    if (r < n_out) {
      OutT* o = out + (size_t)r * cout + n0 + j * 8 + cb;
      if constexpr (sizeof(OutT) == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        union { uint2 u; __nv_bfloat16 h[4]; } b;
#pragma unroll
        for (int e = 0; e < 4; ++e) b.h[e] = to_out(v[e], (OutT*)nullptr);
        *reinterpret_cast<uint2*>(o) = b.u;
      }
    }
  }
}

// Opt `kernel` in to `bytes` of dynamic shared memory (past 48 KB), once
// per kernel and size: the host call costs microseconds per launch.
template <auto Kernel>
int allow_smem(int bytes) {
  static int allowed = 0;               // one value per kernel
  if (bytes <= allowed) return 0;
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc == 0) allowed = bytes;
  return rc;
}

// Launch a conv_tile kernel on a grid of M-row x NT-channel tiles with its
// dynamic shared memory (opted in past 48 KB); returns the CUDA error code.
template <int NT, auto Kernel, typename... Args>
int launch_tile(int n_out, int cin, int cout, int K, cudaStream_t stream,
                Args... args) {
  int stages, ips;
  pick_stages(cin, NT, K, kernel_regs<Kernel>(), stages, ips);
  if (stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = Layout(cin, NT, K, stages, ips).bytes;
  if (bytes > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int rc = allow_smem<Kernel>(bytes);
  if (rc) return rc;
  dim3 grid((n_out + M - 1) / M, cout / NT);
  Kernel<<<grid, THREADS, bytes, stream>>>(args..., stages, ips);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv_tile
