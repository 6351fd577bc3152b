"""upload_ms.infer: the median over the pool's batches of the packed upload
(pack, one copy to the card, decode), each run alone and synchronised after
the window (ms)."""

import statistics


def read(obs):
    if 'stages' not in obs:
        return None
    return statistics.median(s['upload_ms'] for s in obs['stages'])
