"""upload_ms.train: the median over the pool's batches of
engine/hostload.upload of a batch, each run alone and synchronised after the
window (ms)."""

import statistics


def read(obs):
    if 'train_stages' not in obs:
        return None
    return statistics.median(s['upload_ms'] for s in obs['train_stages'])
