"""forward_ms.infer: the median over the pool's batches of the eval forward
(maps and model), each run alone and synchronised after the window (ms)."""

import statistics


def read(obs):
    if 'stages' not in obs:
        return None
    return statistics.median(s['forward_ms'] for s in obs['stages'])
