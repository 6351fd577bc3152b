"""idle_share.train: the share of a traced stretch of the window's own loop in
which no operation ran on the card (%), from torch.profiler's device events
(their union)."""


def read(obs):
    if 'profile' not in obs:
        return None
    p = obs['profile']
    if p['window_s'] <= 0 or p['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - p['busy_s'] / p['window_s'])
