"""Share of the viterbi stage's least time on an H100 (``rxbench.work.viterbi``)
in the trace time of the kernels ``kernel_names/viterbi/`` lists."""

from rxbench.metrics import roofline_pct


def read(record):
    return roofline_pct(record, "viterbi")
