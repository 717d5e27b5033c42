"""The multiply's share of its roofline, %: its least time on the card
(``portbench/work.py``: bytes over the HBM rate, 32-bit operations over the
integer rate) over the device time of the kernels launched inside its span
in the profiled window, a step."""

from portbench import work


def read(rec):
    t = rec.get('trace', {}).get('span_device_s', {}).get('mult')
    if not t or 'mult' not in rec.get('work', {}):
        return None
    return 100.0 * work.least_s(rec['work']['mult'], rec['int_peak']) / (t / rec['trace']['steps'])
