"""Median host time of the entry call a chunk (input copy, graph replay or
eager launches, output clones), without the fetch."""

import numpy as np


def read(record):
    v = record.spans.get("entry")
    return float(np.median(v) * 1e3) if v else None
