"""Forward-FLOPs accounting for SelectionNet on a padded pyramid (the
port's copy of box2mask_tpu/nn/flops.py; the same integer).

Counts 2*N*K*Cin*Cout MACs per conv site over the ACTIVE rows of each level
(upper bound: assumes every kernel offset has a neighbor; real occupancy at
ScanNet sparsity is ~40-70%, so true useful FLOPs are lower). Gives an
approximate device MFU (chip_smoke.py phase 3), to see whether the wall is
compute, memory or the host.

Topology mirrored from nn/unet.py (reference models/detection_net.py:13-27):
stem 5^3 -> 7x (down 2^3 + `layers` BasicBlocks) -> 7x (up + blocks) ->
segment pooling + head MLPs.
"""

from __future__ import annotations

from box2mask_torch.nn.unet import INIT_DIM, ENC_PLANES, DEC_PLANES


def _conv(n, k, cin, cout):
    return 2 * n * k * cin * cout


def _block(n, cin, planes):
    f = _conv(n, 27, cin, planes) + _conv(n, 27, planes, planes)
    if cin != planes:
        f += _conv(n, 1, cin, planes)       # 1x1 projection
    return f


def estimate_forward_flops(ns, layers=2, num_classes=20, n_heads=4,
                           n_segments=0, in_dim=3, stem_kernel=5):
    """ns: active voxel counts per level (list of 8).

    Returns total forward FLOPs (multiply+add counted as 2)."""
    f = _conv(ns[0], stem_kernel ** 3, in_dim, INIT_DIM)
    width = INIT_DIM
    enc_out = [INIT_DIM]                      # encoder output width per level
    for l in range(1, 8):
        f += _conv(ns[l], 8, width, width)    # stride-2 down conv
        planes = ENC_PLANES[l - 1]
        f += _block(ns[l], width, planes)
        for _ in range(layers - 1):
            f += _block(ns[l], planes, planes)
        width = planes
        enc_out.append(planes)
    for i, l in enumerate(range(6, -1, -1)):  # decoder
        planes = DEC_PLANES[i]
        f += _conv(ns[l], 8, width, planes)   # transpose conv
        cin = planes + enc_out[l]             # skip concat
        f += _block(ns[l], cin, planes)
        for _ in range(layers - 1):
            f += _block(ns[l], planes, planes)
        width = planes
    # head MLPs on the pooled segment axis (2 hidden 96 layers + out)
    n = n_segments or ns[0]
    per_head = _conv(n, 1, width, 96) + _conv(n, 1, 96, 96) \
        + _conv(n, 1, 96, num_classes)
    f += n_heads * per_head
    return f
