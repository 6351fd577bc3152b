"""The port's forward-FLOPs count (box2mask_torch/nn/flops.py) equals the
JAX package's (box2mask_tpu/nn/flops.py) as an integer, over a grid of
active rows per level, depths, heads, segments, input widths and stem
kernels; and reads the port's U-Net widths."""

import pytest

from box2mask_tpu.nn import flops as JF
from box2mask_torch.nn import flops as PF
from box2mask_torch.nn import unet

NS = {'scannet': [151000, 131000, 60000, 21000, 5500, 1330, 370, 80],
      'tiny': [900, 400, 150, 40, 9, 3, 1, 1],
      'empty_deep': [5000, 2000, 0, 0, 0, 0, 0, 0]}


@pytest.mark.parametrize('ns,layers,classes,heads,segments,in_dim,stem', [
    ('scannet', 2, 20, 4, 2048, 6, 5),
    ('scannet', 2, 20, 4, 0, 3, 5),
    ('scannet', 1, 18, 3, 0, 6, 3),
    ('tiny', 3, 13, 6, 64, 3, 5),
    ('tiny', 1, 20, 1, 0, 9, 1),
    ('empty_deep', 2, 28, 4, 300, 6, 5)])
def test_estimate_forward_flops_matches_jax(ns, layers, classes, heads,
                                            segments, in_dim, stem):
    kw = dict(layers=layers, num_classes=classes, n_heads=heads,
              n_segments=segments, in_dim=in_dim, stem_kernel=stem)
    got = PF.estimate_forward_flops(NS[ns], **kw)
    want = JF.estimate_forward_flops(NS[ns], **kw)
    assert type(got) is int and got == want and got > 0


def test_reads_the_port_widths():
    assert (PF.INIT_DIM, PF.ENC_PLANES, PF.DEC_PLANES) == (
        unet.INIT_DIM, unet.ENC_PLANES, unet.DEC_PLANES)
    assert (PF.INIT_DIM, tuple(PF.ENC_PLANES), tuple(PF.DEC_PLANES)) == (
        JF.INIT_DIM, tuple(JF.ENC_PLANES), tuple(JF.DEC_PLANES))
