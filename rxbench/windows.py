"""The receiver windows of each entry, worked out again for the reference.

A streaming receiver decodes each chunk in a window that starts ``overlap``
samples before the chunk and keeps the frames that start in the window's
first ``chunk_len`` samples; the time-sharded streaming receiver cuts that
window, zero-padded to a whole number of shards, into ``n_time`` shard
windows of ``t_local + overlap`` samples (the last one's tail zero) and keeps
in each the frames that start in its own ``t_local`` samples. Both return
the kept frames of pool chunk ``i`` as flat numpy arrays: ``row``, ``pos``
(the frame's start on the circle) and the receiver's fields.
"""

from __future__ import annotations

import numpy as np
import torch

from rxbench import frame as fr
from rxbench import reference
from rxbench.tx import Pool

FIELDS = ("header_valid", "payload_valid", "modulation", "inner_code", "outer_code",
          "payload_len", "header_user", "payload", "evm", "rssi", "cfo")


def stream_window(pool: Pool, i: int, overlap: int, device) -> torch.Tensor:
    """[B, overlap + L]: the tail of chunk i - 1 (around the circle), then chunk i."""
    prev = pool.chunks[(i - 1) % pool.n_chunks][:, -overlap:]
    return torch.cat([prev.to(device), pool.chunks[i].to(device)], dim=1)


def frames_by_chunk(layout: fr.Layout, overlap: int, chunk_len: int) -> np.ndarray:
    """[pool chunks]: the frames (all channels) whose start pool chunk i's
    window keeps, those that start in [i * chunk_len - overlap, (i + 1) *
    chunk_len - overlap) on the circle; every frame is kept by one chunk.
    The same for both receivers."""
    pos = np.mod(layout.starts + overlap, layout.circle)
    return np.bincount((pos // chunk_len).reshape(-1), minlength=layout.circle // chunk_len)


def _kept(res: dict, keep: torch.Tensor, row: torch.Tensor, pos: torch.Tensor) -> dict:
    keep = keep & res["mask"]
    out = {"row": row.expand_as(keep)[keep], "pos": pos[keep]}
    out.update({f: res[f][keep] for f in FIELDS})
    return {k: v.cpu().numpy() for k, v in out.items()}


def stream_frames(pool: Pool, i: int, cfg: fr.Config, slots: int, q: reference.Precision,
                  device) -> dict:
    """The frames a streaming receiver keeps from pool chunk ``i``."""
    ov, chunk_len = cfg.overlap, pool.chunks.shape[-1]
    x = stream_window(pool, i, ov, device)
    res = reference.decode_block(x, cfg, slots, q)
    keep = res["start"] <= x.shape[-1] - cfg.frame_samples
    circle = pool.n_chunks * chunk_len
    pos = (res["start"] + (i * chunk_len - ov)) % circle
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return _kept(res, keep, rows, pos)


def sharded_frames(pool: Pool, i: int, cfg: fr.Config, n_time: int, slots: int,
                   q: reference.Precision, device) -> dict:
    """The frames a time-sharded streaming receiver over ``n_time`` shards
    keeps from pool chunk ``i``."""
    ov, chunk_len = cfg.overlap, pool.chunks.shape[-1]
    x = stream_window(pool, i, ov, device)
    real = x.shape[-1]
    window = real + (-real) % n_time
    t_local = window // n_time
    x = torch.nn.functional.pad(x, (0, window + ov - real))  # the last shard's tail is zero
    b = x.shape[0]
    shards = torch.stack([x[:, s * t_local : s * t_local + t_local + ov] for s in range(n_time)])
    res = reference.decode_block(shards.reshape(n_time * b, t_local + ov), cfg, slots, q)
    first = (torch.arange(n_time, device=x.device) * t_local).repeat_interleave(b)[:, None]
    start = res["start"] + first  # in the whole window
    keep = (res["start"] < t_local) & (start <= real - cfg.frame_samples)
    circle = pool.n_chunks * chunk_len
    pos = (start + (i * chunk_len - ov)) % circle
    rows = torch.arange(b, device=x.device).repeat(n_time)[:, None]
    return _kept(res, keep, rows, pos)
