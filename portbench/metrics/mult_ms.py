"""Milliseconds between CUDA events around ``engine.mult`` (mean over the
traced window's steps)."""


def read(rec):
    v = rec.get('spans', {}).get('mult')
    return sum(v) / len(v) if v else None
