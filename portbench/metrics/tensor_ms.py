"""Device milliseconds a step of the BFV tensor product: the program's span
``bfv.tensor_product`` (``schemes/bfv.py`` ``BfvEngine.mult``, between B2
and B4 at the 32-bit word), between its CUDA events, summed over the
profiled window and divided by the window's steps."""

from portbench import program_spans


def read(rec):
    return program_spans.device_ms_per_step('bfv.tensor_product')
