"""The host's milliseconds a step from the call into the entry to its
return, before the synchronize: the enqueue (mean over the traced window)."""


def read(rec):
    return sum(rec['host_s']) / len(rec['host_s']) * 1e3
