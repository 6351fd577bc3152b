/* Native host-side kernels for the data pipeline.
 *
 * The reference outsources these to sklearn/scipy (ball-tree 1-NN
 * voxelization, models/dataloader.py:75-77) and numpy (unique). Implemented
 * here in C for the hot per-scene path:
 *
 *   voxelize(): round scaled points to voxel coords, sort/unique packed keys,
 *     inverse map, and EXACT nearest-point-per-voxel via 3^3 neighborhood
 *     search (the nearest point to a voxel center lies within half the voxel
 *     diagonal (<=0.866 vox), and any point outside the 3^3 neighborhood is
 *     >= 1.5 vox away, so scanning the 27 neighboring voxels' points is
 *     exact).
 *
 *   unpack_masks(): bit test of packed voxel masks and the voxel->point
 *     projection in one pass.
 *
 * The port's copy of box2mask_tpu/native/hostops.c. Built with cc into
 * box2mask_torch/build/ at first use and bound with ctypes
 * (box2mask_torch/native/__init__.py); the NumPy paths are the plain
 * versions, taken only under use_native_host_ops False.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

typedef struct {
    int64_t key;
    int32_t idx;
} KeyIdx;

/* LSD radix sort on the 63-bit packed key, 16-bit digits (4 passes).
 * Stable, so equal keys keep ascending point order (deterministic inverse
 * maps) — and ~4x faster than qsort's comparator calls at 100k+ points. */
static int radix_sort_keyidx(KeyIdx* a, int32_t n) {
    KeyIdx* tmp = (KeyIdx*)malloc(sizeof(KeyIdx) * (size_t)n);
    if (!tmp) return -1;
    static const int R = 1 << 16;
    int32_t* count = (int32_t*)malloc(sizeof(int32_t) * (size_t)R);
    if (!count) { free(tmp); return -1; }
    KeyIdx* src = a; KeyIdx* dst = tmp;
    for (int pass = 0; pass < 4; pass++) {
        const int shift = 16 * pass;
        memset(count, 0, sizeof(int32_t) * (size_t)R);
        for (int32_t i = 0; i < n; i++)
            count[(src[i].key >> shift) & 0xFFFF]++;
        if (count[(src[0].key >> shift) & 0xFFFF] == n) continue; /* all equal */
        int32_t sum = 0;
        for (int d = 0; d < R; d++) { int32_t c = count[d]; count[d] = sum; sum += c; }
        for (int32_t i = 0; i < n; i++)
            dst[count[(src[i].key >> shift) & 0xFFFF]++] = src[i];
        KeyIdx* sw = src; src = dst; dst = sw;
    }
    if (src != a) memcpy(a, src, sizeof(KeyIdx) * (size_t)n);
    free(tmp); free(count);
    return 0;
}

#define SHIFT 21
#define OFF 256

static inline int64_t pack3(int32_t x, int32_t y, int32_t z) {
    return (((int64_t)(x + OFF)) << (2 * SHIFT))
         | (((int64_t)(y + OFF)) << SHIFT)
         | ((int64_t)(z + OFF));
}

/* binary search over sorted unique keys */
static inline int32_t lookup_key(const int64_t* keys, int32_t n, int64_t q) {
    int32_t lo = 0, hi = n - 1;
    while (lo <= hi) {
        int32_t mid = lo + (hi - lo) / 2;
        if (keys[mid] < q) lo = mid + 1;
        else if (keys[mid] > q) hi = mid - 1;
        else return mid;
    }
    return -1;
}

/* Full voxelization.
 * in:  scaled_pts (P*3 float), P
 * out: vox_coords (cap V*3 int32), vox2point (P int32; point -> voxel row),
 *      point2vox (cap V int32; voxel row -> nearest point index)
 * returns V (number of unique voxels), or -1 on alloc failure.
 */
int32_t b2m_voxelize(const float* scaled_pts, int32_t P,
                     int32_t* vox_coords, int32_t* vox2point,
                     int32_t* point2vox) {
    KeyIdx* ki = (KeyIdx*)malloc(sizeof(KeyIdx) * (size_t)P);
    int32_t* pcoord = (int32_t*)malloc(sizeof(int32_t) * (size_t)P * 3);
    if (!ki || !pcoord) { free(ki); free(pcoord); return -1; }

    for (int32_t i = 0; i < P; i++) {
        /* round-half-to-even like np.round */
        float fx = scaled_pts[3 * i], fy = scaled_pts[3 * i + 1],
              fz = scaled_pts[3 * i + 2];
        int32_t x = (int32_t)llrintf(fx);
        int32_t y = (int32_t)llrintf(fy);
        int32_t z = (int32_t)llrintf(fz);
        pcoord[3 * i] = x; pcoord[3 * i + 1] = y; pcoord[3 * i + 2] = z;
        ki[i].key = pack3(x, y, z);
        ki[i].idx = i;
    }
    if (radix_sort_keyidx(ki, P) != 0) { free(ki); free(pcoord); return -1; }

    /* unique + inverse */
    int64_t* ukeys = (int64_t*)malloc(sizeof(int64_t) * (size_t)P);
    if (!ukeys) { free(ki); free(pcoord); return -1; }
    int32_t V = 0;
    for (int32_t i = 0; i < P; i++) {
        if (i == 0 || ki[i].key != ki[i - 1].key) {
            ukeys[V] = ki[i].key;
            const int32_t p = ki[i].idx;
            vox_coords[3 * V] = pcoord[3 * p];
            vox_coords[3 * V + 1] = pcoord[3 * p + 1];
            vox_coords[3 * V + 2] = pcoord[3 * p + 2];
            V++;
        }
        vox2point[ki[i].idx] = V - 1;
    }

    /* CSR of points per voxel (in sorted order ki is already grouped) */
    int32_t* starts = (int32_t*)malloc(sizeof(int32_t) * ((size_t)V + 1));
    if (!starts) { free(ki); free(pcoord); free(ukeys); return -1; }
    {
        int32_t v = -1;
        for (int32_t i = 0; i < P; i++) {
            if (i == 0 || ki[i].key != ki[i - 1].key) starts[++v] = i;
        }
        starts[V] = P;
    }

    /* Exact nearest point per voxel over the 3^3 neighborhood.
     * Voxels ascend in key order, so for each of the 9 (dx,dy) column pairs
     * the neighbor key range [q-1, q+1] (the three dz candidates are three
     * CONSECUTIVE key integers) advances monotonically -> one merge pointer
     * per pair, O(27V) total instead of 27 binary searches per voxel. */
    {
        int32_t ptr[9];
        for (int j = 0; j < 9; j++) ptr[j] = 0;
        for (int32_t v = 0; v < V; v++) {
            const float cx = (float)vox_coords[3 * v];
            const float cy = (float)vox_coords[3 * v + 1];
            const float cz = (float)vox_coords[3 * v + 2];
            float best = 1e30f;
            int32_t best_i = ki[starts[v]].idx;
            int j = 0;
            for (int dx = -1; dx <= 1; dx++)
            for (int dy = -1; dy <= 1; dy++, j++) {
                const int64_t q0 = pack3(vox_coords[3 * v] + dx,
                                         vox_coords[3 * v + 1] + dy,
                                         vox_coords[3 * v + 2] - 1);
                int32_t p0 = ptr[j];
                while (p0 < V && ukeys[p0] < q0) p0++;
                ptr[j] = p0;
                for (int32_t nv = p0; nv < V && ukeys[nv] <= q0 + 2; nv++) {
                    for (int32_t s = starts[nv]; s < starts[nv + 1]; s++) {
                        const int32_t p = ki[s].idx;
                        const float ddx = scaled_pts[3 * p] - cx;
                        const float ddy = scaled_pts[3 * p + 1] - cy;
                        const float ddz = scaled_pts[3 * p + 2] - cz;
                        const float d = ddx * ddx + ddy * ddy + ddz * ddz;
                        if (d < best || (d == best && p < best_i)) {
                            best = d;
                            best_i = p;
                        }
                    }
                }
            }
            point2vox[v] = best_i;
        }
    }

    free(ki); free(pcoord); free(ukeys); free(starts);
    return V;
}

/* Unpack bit-packed voxel masks and project voxel->point in one pass.
 * packed: (R, stride) bytes, voxel v of this scene at BIT offset v (the
 * scene's voxel columns start at byte offset base_byte, base_byte*8 must be
 * the scene's first voxel column); vox2point: (P,) voxel row per point.
 * out: (R, P) uint8 point masks. */
void b2m_unpack_masks(const uint8_t* packed, int32_t R, int32_t stride,
                      int32_t base_byte, const int32_t* vox2point, int32_t P,
                      uint8_t* out) {
    for (int32_t r = 0; r < R; r++) {
        const uint8_t* row = packed + (size_t)r * stride + base_byte;
        uint8_t* o = out + (size_t)r * P;
        for (int32_t p = 0; p < P; p++) {
            const int32_t v = vox2point[p];
            o[p] = (row[v >> 3] >> (v & 7)) & 1;
        }
    }
}
