"""The whole step's share of the card's peak, %: the least time of all the
step's work (``portbench/work.py``) over the profiled window's seconds a
step, idle time included. It bounds what any kernel's gain can show."""

from portbench import work


def read(rec):
    tr = rec.get('trace')
    if not tr or 'step' not in rec.get('work', {}):
        return None
    step_s = tr['window_s'] / tr['steps']
    return 100.0 * work.least_s(rec['work']['step'], rec['int_peak']) / step_s
