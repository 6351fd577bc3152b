"""The level pyramid and every conv's neighbours, from dense occupancy
grids (PyTorch, on any device).

Level l holds the distinct cells floor(c / 2^l) of the scene's voxels c,
in lexicographic order; level 0 keeps the voxels' own order. The rows of a
batch are the scenes' rows one after the other. For each conv the table
`nbr` (rows, K) gives the input row that each kernel slot reads, or -1:

  same level, kernel 3 or 5   input cell c + d, d in {-h..h}^3 x-major
  down l -> l+1 (2^3)         input cell 2u + o of output cell u, o in
                              {0,1}^3 x-major
  up l+1 -> l (transpose)     slot o = c - 2 floor(c / 2) of output cell c
                              reads its parent floor(c / 2); other slots -1

A cell's neighbour is looked up in a grid that holds each occupied cell's
row, one scene at a time.
"""

from __future__ import annotations

import itertools

import torch

NUM_LEVELS = 8


def offsets(kernel_size, stride=False):
    rng = (0, 1) if stride else range(-(kernel_size // 2),
                                       kernel_size // 2 + 1)
    return torch.tensor(list(itertools.product(rng, rng, rng)),
                        dtype=torch.int64)


class _Grid:
    """Row of each occupied cell of one scene and level (-1 elsewhere)."""

    def __init__(self, cells, base):
        self.dims = cells.max(0).values + 1
        d = self.dims.tolist()
        self.grid = torch.full((d[0] * d[1] * d[2],), -1, dtype=torch.int64,
                               device=cells.device)
        self.grid[self._flat(cells)] = base + torch.arange(
            len(cells), device=cells.device)

    def _flat(self, q):
        d = self.dims
        return (q[..., 0] * d[1] + q[..., 1]) * d[2] + q[..., 2]

    def lookup(self, q):
        inside = ((q >= 0) & (q < self.dims)).all(-1)
        flat = self._flat(torch.where(inside[..., None], q, 0))
        return torch.where(inside, self.grid[flat], -1)


def build(scene_coords, device):
    """scene_coords: per scene (n, 3) int voxel cells (lexicographic,
    distinct). Returns dict: n (rows per level), scene (per level, the
    scene of each row), nbr3 (per level), nbr5 (level 0), down (l -> l+1,
    l = 0..6), up (l+1 -> l, l = 0..6)."""
    off3, off5 = offsets(3).to(device), offsets(5).to(device)
    off2 = offsets(2, stride=True).to(device)
    cells = [[torch.as_tensor(c, dtype=torch.int64, device=device)]
             for c in scene_coords]
    for per in cells:
        for l in range(1, NUM_LEVELS):
            per.append(torch.unique(per[0] >> l, dim=0))
    n = [sum(len(per[l]) for per in cells) for l in range(NUM_LEVELS)]
    base = [[0] * len(cells) for _ in range(NUM_LEVELS)]
    for l in range(NUM_LEVELS):
        acc = 0
        for b, per in enumerate(cells):
            base[l][b] = acc
            acc += len(per[l])
    out = {'n': n, 'scene': [], 'nbr3': [[] for _ in range(NUM_LEVELS)],
           'nbr5': [], 'down': [[] for _ in range(NUM_LEVELS - 1)],
           'up': [[] for _ in range(NUM_LEVELS - 1)]}
    for l in range(NUM_LEVELS):
        out['scene'].append(torch.cat([
            torch.full((len(per[l]),), b, dtype=torch.int64, device=device)
            for b, per in enumerate(cells)]))
    for b, per in enumerate(cells):
        grids = [_Grid(per[l], base[l][b]) for l in range(NUM_LEVELS)]
        for l in range(NUM_LEVELS):
            c = per[l]
            out['nbr3'][l].append(grids[l].lookup(c[:, None] + off3))
            if l == 0:
                out['nbr5'].append(grids[0].lookup(c[:, None] + off5))
            if l + 1 < NUM_LEVELS:
                coarse = per[l + 1]
                out['down'][l].append(grids[l].lookup(
                    2 * coarse[:, None] + off2))
                parent = grids[l + 1].lookup(c >> 1)
                slot = ((c & 1) * torch.tensor([4, 2, 1], device=device)
                        ).sum(1)
                up = torch.full((len(c), 8), -1, dtype=torch.int64,
                                device=device)
                up[torch.arange(len(c), device=device), slot] = parent
                out['up'][l].append(up)
        del grids
    for key in ('nbr3', 'down', 'up'):
        out[key] = [torch.cat(t) for t in out[key]]
    out['nbr5'] = torch.cat(out['nbr5'])
    return out
