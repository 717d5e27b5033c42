"""Device milliseconds a step of the bootstrap's stage ``btp.evalmod``
(``schemes/bootstrap.py`` ``CkksBootstrapper.__call__``): the Chebyshev series
and the double angles of EvalMod, both halves at once. The program's span,
between its CUDA events, summed over the profiled window and divided by the
window's steps."""

from portbench import program_spans


def read(rec):
    return program_spans.device_ms_per_step('btp.evalmod')
