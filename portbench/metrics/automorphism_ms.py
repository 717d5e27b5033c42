"""Device milliseconds a step of the Galois automorphism of both components:
the program's span ``galois.automorphism`` (``schemes/bfv.py``
``BfvEngine.apply_galois``, before the key switch), between its CUDA events,
summed over the profiled window and divided by the window's steps."""

from portbench import program_spans


def read(rec):
    return program_spans.device_ms_per_step('galois.automorphism')
