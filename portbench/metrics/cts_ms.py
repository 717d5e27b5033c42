"""Device milliseconds a step of the bootstrap's stage ``btp.cts``
(``schemes/bootstrap.py`` ``CkksBootstrapper.__call__``): CoeffsToSlots, its
real and imaginary split included. The program's span, between its CUDA
events, summed over the profiled window and divided by the window's steps."""

from portbench import program_spans


def read(rec):
    return program_spans.device_ms_per_step('btp.cts')
