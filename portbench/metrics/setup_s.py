"""Seconds from the process's start to the window: imports, key generation,
encryption and the warm-up (and, in a checkout's first run, the kernels'
build)."""


def read(rec):
    return rec['setup_s']
