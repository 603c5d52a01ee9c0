"""``chunk_latency_ms_p95`` where the stream is handed over by ``push``: from
the push that completes a chunk to its results on the host."""

from rxbench.metrics import p95_ms


def read(record):
    return p95_ms(record.latencies) if "ingest" in record.spans else None
