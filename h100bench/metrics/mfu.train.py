"""mfu.train: the whole window's share of the card's dense bf16 peak (%): the
operations of every step (forward, dx but the stem's, dw) the window ran,
counted from matched pairs (flops.py), over the window's seconds and the
peak."""


def read(obs):
    if 'window' not in obs:
        return None
    w = obs['window']
    if w['seconds'] <= 0 or w['flops'] <= 0:
        return None
    return 100.0 * w['flops'] / w['seconds'] / w['peak_flop_s']
