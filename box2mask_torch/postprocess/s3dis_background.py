"""S3DIS background instance assembly (walls/floor/ceiling are not voted —
protocol-parity with reference utils/s3dis_util.py:137-177); the port's copy
of box2mask_tpu/postprocess/s3dis_background.py:

  * ceiling (class 0) and floor (class 1) each form one instance per room,
  * walls (class 2) are clustered by DBSCAN(eps=.35, min_samples=10) over
    [coords, 2*normals]; clusters under 3000 points are suppressed,
  * per-proposal semantics = majority vote of per-point semantic predictions.

The JAX package calls scikit-learn's DBSCAN; the port has its own (`dbscan`,
on scipy's k-d tree), which gives scikit-learn's labels, not merely its
partition: the wall instance ids feed the S3DIS protocol.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree


def dbscan(x, eps, min_samples):
    """Cluster labels of `x` (N, D) as sklearn.cluster.DBSCAN(eps,
    min_samples).fit(x).labels_ gives them: a core point has at least
    `min_samples` points within `eps` (itself included); clusters are the
    connected components of core points within `eps` of each other,
    numbered in the index order of their first core point; a border point
    (not core, within `eps` of a core point) takes the smallest-numbered
    cluster that reaches it, as scikit-learn's expansion, cluster after
    cluster, does; every other point is noise, -1."""
    x = np.asarray(x, np.float64)
    n = len(x)
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    pairs = cKDTree(x).query_pairs(eps, output_type='ndarray')
    i, j = pairs[:, 0], pairs[:, 1]
    core = np.bincount(np.concatenate([i, j]), minlength=n) + 1 >= min_samples
    both = core[i] & core[j]
    adj = coo_matrix((np.ones(int(both.sum()), np.int8), (i[both], j[both])),
                     shape=(n, n))
    _, comp = connected_components(adj, directed=False)
    # number the components of core points by their first core point
    first = np.full(n, n, np.int64)
    idx = np.nonzero(core)[0]
    np.minimum.at(first, comp[idx], idx)
    order = np.argsort(first, kind='stable')
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    labels[core] = rank[comp[core]]
    # border points: the smallest cluster label among their core neighbours
    border = np.full(n, np.iinfo(np.int64).max, np.int64)
    for a, b in ((i, j), (j, i)):
        sel = core[a] & ~core[b]
        np.minimum.at(border, b[sel], labels[a[sel]])
    hit = border < np.iinfo(np.int64).max
    labels[hit] = border[hit]
    return labels


def assign_semantics_to_proposals(pred_semantics, proposal_masks):
    out = []
    for mask in proposal_masks:
        m = np.asarray(mask) > 0
        out.append(np.bincount(pred_semantics[m]).argmax() if m.any() else 0)
    return np.array(out)


def clustering_for_background(pred_semantics, coords, normals):
    pred_instances = np.zeros_like(pred_semantics, dtype=np.int32)
    pred_instances[pred_semantics == 0] = 1      # ceiling
    pred_instances[pred_semantics == 1] = 2      # floor

    wall = pred_semantics == 2
    if wall.sum() > 10:
        feats = np.concatenate([coords[wall], normals[wall] * 2], axis=1)
        labels = dbscan(feats, eps=0.35, min_samples=10) + 4
        ids, cnts = np.unique(labels, return_counts=True)
        small = np.isin(labels, ids[cnts < 3000])
        labels[small] = -1
        pred_instances[wall] = labels
    return pred_instances
