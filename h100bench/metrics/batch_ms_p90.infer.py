"""batch_ms_p90.infer: the 90th percentile over every batch of the traced
run's window of the time from the pipeline taking the batch to its results
(ms)."""


def read(obs):
    w = obs.get('window')
    if w is None or 'p90_ms' not in w:
        return None
    return w['p90_ms']
