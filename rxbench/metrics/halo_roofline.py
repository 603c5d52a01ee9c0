"""Share of the halo stage's least time on an H100 (``rxbench.work.halo``)
in the trace time of the kernels ``kernel_names/halo/`` lists."""

from rxbench.metrics import roofline_pct


def read(record):
    return roofline_pct(record, "halo")
