"""The key switch's share of its roofline, %: its least time on the card
(``portbench/work.py``) over the device time of the kernels launched inside
its span (relinearize or apply_galois) in the profiled window, a step."""

from portbench import work


def read(rec):
    t = rec.get('trace', {}).get('span_device_s', {}).get('keyswitch')
    if not t or 'keyswitch' not in rec.get('work', {}):
        return None
    return (100.0 * work.least_s(rec['work']['keyswitch'], rec['int_peak'])
            / (t / rec['trace']['steps']))
