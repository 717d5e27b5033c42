"""Device milliseconds a step of the bootstrap's stage ``btp.stc``
(``schemes/bootstrap.py`` ``CkksBootstrapper.__call__``): the merge of the two
halves, SlotsToCoeffs and any steer onto the input's scale. The program's
span, between its CUDA events, summed over the profiled window and divided by
the window's steps."""

from portbench import program_spans


def read(rec):
    return program_spans.device_ms_per_step('btp.stc')
