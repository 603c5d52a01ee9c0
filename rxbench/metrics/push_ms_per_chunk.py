"""Host time in ``StreamingRx.push`` calls a chunk (its pieces summed; the
last push steps the receiver), mean over the window's untraced chunks."""

import numpy as np


def read(record):
    v = record.spans.get("ingest")
    return float(np.mean(v) * 1e3) if v else None
