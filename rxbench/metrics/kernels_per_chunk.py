"""Kernel launches on the card a traced chunk (graph replays' included)."""


def read(record):
    t = record.trace
    return t.kernels / t.chunks if t is not None and t.kernels > 0 else None
