"""Device-busy time (kernels, copies and fills, their union) a traced chunk."""


def read(record):
    t = record.trace
    return t.busy_s / t.chunks * 1e3 if t is not None and t.busy_s > 0 else None
