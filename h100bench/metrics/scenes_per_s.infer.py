"""scenes_per_s.infer: scenes whose results the pipeline yielded over the
window's seconds (scenes/s), the window of the traced run; the same number
as a --trace 0 run's rate, kept per layer where the host's clock spreads it
too widely for a bound."""


def read(obs):
    w = obs.get('window')
    if w is None or 'scenes' not in w or w['seconds'] <= 0:
        return None
    return w['scenes'] / w['seconds']
