"""The 95th percentile of every step's milliseconds in the window, a step
being one batched call ended by a synchronize (linear interpolation between
order statistics)."""


def read(rec):
    v = sorted(rec['step_s'])
    pos = 0.95 * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return (v[lo] + (v[hi] - v[lo]) * (pos - lo)) * 1e3
