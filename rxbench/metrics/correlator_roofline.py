"""Share of the correlator stage's least time on an H100 (``rxbench.work.correlator``)
in the trace time of the kernels ``kernel_names/correlator/`` lists."""

from rxbench.metrics import roofline_pct


def read(record):
    return roofline_pct(record, "correlator")
