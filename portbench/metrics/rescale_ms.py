"""Device milliseconds a step of the CKKS rescale: the program's span
``ckks.rescale`` (``schemes/ckks.py`` ``CkksEngine.rescale``: the INTT, the
divide-and-round by the last prime, the NTT), between its CUDA events,
summed over the profiled window and divided by the window's steps."""

from portbench import program_spans


def read(rec):
    return program_spans.device_ms_per_step('ckks.rescale')
