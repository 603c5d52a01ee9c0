"""95th percentile over all chunks of the window of the time from the call
that hands the receiver a chunk's last sample to its results on the host."""

from rxbench.metrics import p95_ms


def read(record):
    return p95_ms(record.latencies)
