"""key_conv_roofline.train: the key-matching conv kernels' share of their
roofline over one train step per pool batch (forward, dx, dw and stem dw
launches) (%): the sum of every launch's bound (flops.py: the larger of its
matched-pair operations over the bf16 peak and its bytes over the HBM
bandwidth) over the sum of the device time the profiler gives the kernels
named in device.KEY_CONV_KERNELS. None when the trace holds none of them."""


def read(obs):
    if 'conv' not in obs:
        return None
    c = obs['conv']
    if c['device_s'] <= 0:
        return None
    return 100.0 * c['bound_s'] / c['device_s']
