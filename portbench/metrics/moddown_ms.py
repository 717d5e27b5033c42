"""Device milliseconds a step of the key switch's mod-down: the program's
span ``ksw.moddown`` (``schemes/keyswitch.py``
``KeySwitcher.switch_from_digits``: ``RoundDivP``, the divide-and-round by P
at the 64-bit word), between its CUDA events, summed over the profiled
window and divided by the window's steps."""

from portbench import program_spans


def read(rec):
    return program_spans.device_ms_per_step('ksw.moddown')
