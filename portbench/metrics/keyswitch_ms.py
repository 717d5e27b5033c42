"""Milliseconds between CUDA events around ``engine.relinearize`` (or
``engine.apply_galois`` in a rotation cell), mean over the traced window's
steps."""


def read(rec):
    v = rec.get('spans', {}).get('keyswitch')
    return sum(v) / len(v) if v else None
