// The plan and the scratch layout of csrc/key_conv.cu's weight gradient
// (the three key_conv modes): integer arithmetic on the host alone, with no
// CUDA in it, so that the CPU tests compile this header by itself
// (tests/test_torch_dw_pairs.py) and hold the one layout there is.
#pragma once

#include <stddef.h>

namespace dw_plan {

constexpr int DW_M = 64;          // pairs per dw tile (the product's depth)
constexpr int DW_THREADS = 256;   // 8 warps
constexpr int DW_WARPS = DW_THREADS / 32;
constexpr int PAIR_RPT = 8;       // output rows per thread of the pair build
constexpr int PAIR_CH = DW_THREADS * PAIR_RPT;   // rows per build block
constexpr int DW_WAVES = 2;       // work items: about two waves of blocks
constexpr int DW_BLOCKS_SM = 4;   // the most dw blocks an SM holds
// meta: items, chunk (pairs per item), target items, then per offset k
// (pairs, items, first item) at DW_META + 3 k
constexpr int DW_META = 3;
constexpr int DW_KMAX = 125;      // the most offsets a dw takes (5^3)

inline int table_stride(int n_out) { return (n_out + DW_M - 1) / DW_M * DW_M; }

// How a dw launch splits the channels: CI input channels and NT output
// channels per block (n_z blocks per work item), per warp units of CW input
// x NB output channels: a 32 x 32 unit loads two A and two B fragments per
// eight products. At most 64 f32 accumulators per thread.
struct DwPlan {
  int CI, n_ci, NT, NB, CW, upo, UPW, n_z;
  DwPlan(int cin, int cout) {
    CI = cin <= 128 ? (cin + 15) / 16 * 16 : 128;
    n_ci = (cin + CI - 1) / CI;
    NT = cout % 128 == 0 ? 128 : cout % 96 == 0 ? 96 : cout % 64 == 0 ? 64
         : cout % 32 == 0 ? 32 : 16;
    NB = NT % 32 == 0 ? 32 : 16;
    CW = CI % 32 == 0 ? 32 : 16;
    upo = (CI / CW) * (NT / NB);
    UPW = (upo + DW_WARPS - 1) / DW_WARPS;
    n_z = n_ci * (cout / NT);
  }
  // a ring stage: the g and x tiles, and two pair slots per stage
  int bytes(int stages) const {
    return stages * 2 * DW_M * ((NT + 8) + (CI + 8)) + 2 * stages * DW_M * 8;
  }
  // the most work items a launch on `sms` SMs makes: its target (DW_WAVES
  // waves of the blocks the SMs hold over the n_z channel blocks of an
  // item, less K, at least K; key_conv.cu dw_run) at DW_BLOCKS_SM blocks
  // an SM, plus K for the offsets' last items
  int cap(int K, int sms) const {
    const int t = DW_WAVES * DW_BLOCKS_SM * sms / n_z - K;
    return K + (t > K ? t : K);
  }
};

// The scratch of one dw launch, in ints: the pair lists (K x n_pad int2,
// room for every entry matched), the match table (K x n_pad) sharing its
// memory with the partials (cap x cin x cout f32, written once the table is
// dead), the chunk counts (K x n_chunks) and meta; each region starts on
// 64 ints.
struct DwScratch {
  int n_pad, n_chunks, cap;
  size_t pairs, table, counts, meta, total;
  DwScratch(int n_out, int K, int cin, int cout, int sms) {
    auto up = [](size_t v) { return (v + 63) / 64 * 64; };
    n_pad = table_stride(n_out);
    n_chunks = (n_out + PAIR_CH - 1) / PAIR_CH;
    cap = DwPlan(cin, cout).cap(K, sms);
    const size_t t = (size_t)K * n_pad, p = (size_t)cap * cin * cout;
    pairs = 0;
    table = up(2 * t);
    counts = table + up(t > p ? t : p);
    meta = counts + up((size_t)K * n_chunks);
    total = meta + up(DW_META + 3 * (size_t)K);
  }
  // out = {total, cap, n_pad, n_chunks, pairs, table, counts, meta}
  void write(long long* out) const {
    const size_t v[] = {total, (size_t)cap, (size_t)n_pad, (size_t)n_chunks,
                        pairs, table, counts, meta};
    for (int i = 0; i < 8; ++i) out[i] = (long long)v[i];
  }
};

}  // namespace dw_plan
