"""Homomorphic operations completed in the window over its seconds:
batch × steps / window (the reference SDK's own figure)."""


def read(rec):
    return rec['batch'] * rec['steps'] / rec['window_s']
