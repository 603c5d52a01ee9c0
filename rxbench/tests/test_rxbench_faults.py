"""A run with the timed path broken underneath must come out not correct.

These drive the whole run but its look for a card (on the CPU, at a size it
holds), once sound and once for each fault a cell can have: the step's state
left unchanged (the carry never moves), half the channels left out, the
exchange between time shards left out, and an answer altered where it is
produced."""

import dataclasses

import pytest
import torch

from rxbench import run

SMALL = {"v27golay.chunks": {"batch": 4, "chunk_len": 12288, "pool_chunks": 3},
         "v27golay.push4096": {"batch": 4, "chunk_len": 12288, "pool_chunks": 3},
         "v27golay.sharded8": {"batch": 2, "chunk_len": 24576, "n_time": 4, "pool_chunks": 3}}
SECONDS = 6.0  # several chunks even on a loaded host: the first window chunk follows the wrap, which few frames cross


def _run(workload, seed=2**31 + 77):
    return run.run_cell(workload, seed, SECONDS, False, device="cpu",
                        traffic_override=SMALL[workload])


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def _carry_never_moves(monkeypatch):
    from liquiddsp_tpu_torch.runtime.stream import StreamingRx

    orig = StreamingRx._window

    def window(self, chunk, k, base, with_count):
        head = self._buf[:, : self.overlap].clone()
        out = orig(self, chunk, k, base, with_count)
        self._buf[:, : self.overlap] = head
        return out

    monkeypatch.setattr(StreamingRx, "_window", window)


def _results_edited(monkeypatch, edit):
    from liquiddsp_tpu_torch.runtime import stream

    orig = stream.framesync_fixed

    def framesync_fixed(*a, **kw):
        out = orig(*a, **kw)
        res, count = out if isinstance(out, tuple) else (out, None)
        res = edit(res)
        return (res, count) if count is not None else res

    monkeypatch.setattr(stream, "framesync_fixed", framesync_fixed)


def _half_the_channels(res):
    keep = torch.arange(res.mask.shape[0])[:, None] < res.mask.shape[0] // 2
    return dataclasses.replace(res, mask=res.mask & keep, header_valid=res.header_valid & keep,
                               payload_valid=res.payload_valid & keep)


def _one_byte_flipped(res):
    payload = res.payload.clone()
    payload[0, 0, 0] ^= 1
    return dataclasses.replace(res, payload=payload)


def _cfo_nudged(res):
    return dataclasses.replace(res, cfo=res.cfo + 2e-4)


@pytest.mark.parametrize("workload", ["v27golay.chunks", "v27golay.push4096"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered",
                                   "statistic_altered"])
def test_a_fault_is_not_correct(monkeypatch, workload, fault):
    if fault == "state_unchanged":
        _carry_never_moves(monkeypatch)
    else:
        _results_edited(monkeypatch, {"half_the_batch": _half_the_channels,
                                      "answer_altered": _one_byte_flipped,
                                      "statistic_altered": _cfo_nudged}[fault])
    out = _run(workload)
    assert not out["correct"], out["checks"]


def test_no_exchange_between_shards_is_not_correct(monkeypatch):
    from liquiddsp_tpu_torch.parallel import halo

    orig = halo.halo_windows_dist

    def windows(x_local, mesh, ov):
        w = orig(x_local, mesh, ov).clone()
        w[..., w.shape[-1] - ov :] = 0  # every shard's halo left out
        return w

    monkeypatch.setattr(halo, "halo_windows_dist", windows)
    out = _run("v27golay.sharded8")
    assert not out["correct"], out["checks"]
    assert out["failed"] > 0
