"""Device milliseconds a step of the bootstrap's stage ``btp.raise``
(``schemes/bootstrap.py`` ``CkksBootstrapper.__call__``): the two switching
keys (dense to sparse and back) and ModRaise. The program's span, between its
CUDA events, summed over the profiled window and divided by the window's
steps."""

from portbench import program_spans


def read(rec):
    return program_spans.device_ms_per_step('btp.raise')
