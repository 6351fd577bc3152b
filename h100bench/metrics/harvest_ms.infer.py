"""harvest_ms.infer: the median over the pool's batches of the readback and the
host unpack of the masks, each run alone and synchronised after the window
(ms)."""

import statistics


def read(obs):
    if 'stages' not in obs:
        return None
    return statistics.median(s['harvest_ms'] for s in obs['stages'])
