"""Metric readers: ``<name>.py`` has ``read(record)``, which returns the
metric's value from a run's record, or ``None`` where the run has nothing
for it to read. ``kernel_names/<stage>/*.txt`` list the kernel functions
that compute a stage: a kernel of another name that computes it is added as
a file beside them."""

import numpy as np


def p95_ms(seconds) -> float | None:
    return float(np.percentile(np.asarray(seconds) * 1e3, 95)) if len(seconds) else None


def roofline_pct(record, stage: str) -> float | None:
    """Share of the stage's least time on an H100 (``rxbench.work``) for the
    work the traced chunks' inputs need in the trace time of its kernels."""
    from rxbench import trace, work

    if record.trace is None or not record.stage_work.get(stage):
        return None
    launches, seconds = record.trace.kernel_time(trace.kernel_names(stage))
    if launches == 0 or seconds <= 0:
        return None
    return 100.0 * sum(work.STAGES[stage](*s) for s in record.stage_work[stage]) / seconds
