"""optimizer_ms.train: the median over the pool's batches of the optimizer
update, each run alone and synchronised after the window (ms)."""

import statistics


def read(obs):
    if 'train_stages' not in obs:
        return None
    return statistics.median(s['optimizer_ms'] for s in obs['train_stages'])
