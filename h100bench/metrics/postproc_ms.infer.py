"""postproc_ms.infer: the median over the pool's batches of the fused device
post-processing, each run alone and synchronised after the window (ms)."""

import statistics


def read(obs):
    if 'stages' not in obs:
        return None
    return statistics.median(s['postproc_ms'] for s in obs['stages'])
