"""The device's idle share, %: 1 - the union of its operations' intervals
over the profiled window, both from one torch.profiler window."""


def read(rec):
    tr = rec.get('trace')
    return 100.0 * (1 - tr['busy_s'] / tr['window_s']) if tr and tr['busy_s'] else None
