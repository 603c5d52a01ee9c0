"""What decides ``correct``, and the frame accounting of a run.

Every chunk the window produced is held against the reference's frames of
its pool chunk (``windows.py``): the same frames found at the same starts,
the same header and payload fields and flags, and the float statistics
(EVM, RSSI, CFO) within their limits. The numbers compared and their limits
are in ``limits/<cell>.json``. Separately, every frame sent whole in the
stream the window covered is counted as attempted, and as failed unless its
payload came back bit-exactly, once.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rxbench.windows import FIELDS

DISCRETE = ("header_valid", "payload_valid")
HEADER = ("modulation", "inner_code", "outer_code", "payload_len", "header_user")
GAPS = ("evm", "rssi", "cfo")


@dataclasses.dataclass
class Chunk:
    """One chunk's results as fetched: ``fields`` [R, S] host arrays of the
    receiver's slots, their ``epoch`` and the pool chunk it decoded."""

    index: int
    fields: dict
    epoch: int


def program_frames(chunk: Chunk, circle: int) -> dict:
    """The chunk's valid slots as flat arrays: row, absolute stream ``abs``
    and circle ``pos`` start, and the fields."""
    f = chunk.fields
    keep = f["mask"].astype(bool)
    rows = np.broadcast_to(np.arange(keep.shape[0])[:, None], keep.shape)[keep]
    start = f["start"].astype(np.int64)[keep] + int(chunk.epoch)
    out = {"row": rows, "abs": start, "pos": np.mod(start, circle)}
    out.update({k: f[k][keep] for k in FIELDS})
    return out


def _key(frames: dict, circle: int) -> np.ndarray:
    return frames["row"].astype(np.int64) * circle + frames["pos"].astype(np.int64)


@dataclasses.dataclass
class Differences:
    """Program against reference over the chunks of a run."""

    frames: int = 0  # frames both found
    missing_or_extra: int = 0  # frames found by one side only, or twice
    fields_differ: int = 0  # frames found by both whose flags, header or payload differ
    gaps: dict = dataclasses.field(default_factory=lambda: {g: [] for g in GAPS})

    def numbers(self) -> dict[str, float]:
        out = {"frames_differ": float(self.missing_or_extra + self.fields_differ)}
        for g in GAPS:
            v = np.concatenate(self.gaps[g]) if self.gaps[g] else np.zeros(1)
            out[f"{g}_gap_p50"] = float(np.median(v))
            out[f"{g}_gap_p99"] = float(np.quantile(v, 0.99))
            out[f"{g}_gap_max"] = float(np.max(v))
        return out


def differ(got: dict, want: dict, circle: int, diff: Differences) -> None:
    """Add one chunk's comparison (``got`` from ``program_frames`` or the
    control, ``want`` the reference's frames of its pool chunk)."""
    kg, kw = _key(got, circle), _key(want, circle)
    ug, first_g, count_g = np.unique(kg, return_index=True, return_counts=True)
    uw, first_w = np.unique(kw, return_index=True)
    diff.missing_or_extra += int(np.sum(count_g - 1))
    both, ig, iw = np.intersect1d(ug, uw, return_indices=True)
    diff.missing_or_extra += len(ug) + len(uw) - 2 * len(both)
    a, b = first_g[ig], first_w[iw]
    diff.frames += len(both)
    bad = np.zeros(len(both), dtype=bool)
    for f in DISCRETE:
        bad |= got[f][a].astype(bool) != want[f][b].astype(bool)
    hv = got["header_valid"][a].astype(bool) | want["header_valid"][b].astype(bool)
    for f in HEADER:
        ne = got[f][a] != want[f][b]
        bad |= hv & (ne.reshape(len(both), -1).any(axis=1))
    pv = got["payload_valid"][a].astype(bool) | want["payload_valid"][b].astype(bool)
    bad |= pv & (got["payload"][a] != want["payload"][b]).reshape(len(both), -1).any(axis=1)
    diff.fields_differ += int(bad.sum())
    for g in GAPS:
        diff.gaps[g].append(np.abs(got[g][a].astype(np.float64) - want[g][b].astype(np.float64)))


def account(frames: list[dict], layout, payload: np.ndarray, user: np.ndarray,
            first_base: int, last_end: int) -> tuple[int, int]:
    """(attempted, failed) over the frames sent whole whose stream start lies
    in [first_base, last_end) (the stream the window's chunks kept frames
    from; the frames within a sample of either end are left out, as the
    detector may place them a sample off, in a chunk outside the window).

    ``frames`` are the window's ``program_frames``. A sent frame is decoded
    when exactly one slot lies within a sample of its start with the CRC
    passed, and that slot's payload and user header are the ones sent; a
    slot with the CRC passed that lies on no sent frame, or carries other
    bytes, is a failure too."""
    circle = layout.circle
    b, n = layout.starts.shape
    starts = np.mod(layout.starts, circle)  # [B, n]
    # every start s + c * circle inside [first_base + 1, last_end - 1)
    lo = -(-(first_base + 1 - starts) // circle)
    hi = -(-(last_end - 1 - starts) // circle)
    attempted = int(np.maximum(hi - lo, 0).sum())
    if not frames:
        return attempted, attempted
    cat = lambda k: np.concatenate([f[k] for f in frames])
    ok = cat("payload_valid").astype(bool)
    row, p = cat("row")[ok].astype(np.int64), cat("abs")[ok]
    pay, usr = cat("payload")[ok], cat("header_user")[ok]
    keys = (np.arange(b)[:, None] * circle + starts).reshape(-1)
    order = np.argsort(keys)
    keys = keys[order]
    j = np.full(len(p), -1, dtype=np.int64)
    d = np.zeros(len(p), dtype=np.int64)
    for off in (0, -1, 1):  # the slot's start minus the frame's
        cand = row * circle + np.mod(p - off, circle)
        idx = np.minimum(np.searchsorted(keys, cand), len(keys) - 1)
        hit = (keys[idx] == cand) & (j < 0)
        j[hit], d[hit] = order[idx[hit]] % n, off
    extra = int(np.sum(j < 0))  # a CRC pass on no sent frame
    on = j >= 0
    row, j, true_abs, pay, usr = row[on], j[on], (p - d)[on], pay[on], usr[on]
    good = (pay == payload[row, j]).all(axis=-1) & (usr == user[row, j]).all(axis=-1)
    cycle = (true_abs - starts[row, j]) // circle
    inside = (cycle >= lo[row, j]) & (cycle < hi[row, j])
    ident = ((row * n + j) << 32) + (cycle + (1 << 20))
    ids, inv, counts = np.unique(ident[inside], return_inverse=True, return_counts=True)
    all_good = np.ones(len(ids), dtype=bool)
    np.logical_and.at(all_good, inv, good[inside])
    decoded = int(np.sum((counts == 1) & all_good))
    return attempted, attempted - decoded + extra


def held(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, list[tuple]]:
    """(every number within its limit, [(name, value, limit)])."""
    rows = [(k, numbers[k], float(v)) for k, v in limits.items()]
    return all(val <= lim for _, val, lim in rows), rows
