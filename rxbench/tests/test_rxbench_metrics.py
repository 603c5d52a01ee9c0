"""The yardstick's arithmetic: work from shapes, the trace's reduction, the
metric readers, the frame accounting, and the loading of everything by name."""

import json
import types

import numpy as np
import pytest

from rxbench import compare, run, spec, trace, work
from rxbench import frame as fr

ROOT = spec.ROOT


def test_work_from_shapes():
    # PERF.md's kernel table: 0.0652 ms for the correlator over [64, 65536]
    # (three bf16 products at 989 TFLOP/s), 0.0080 ms for the Viterbi over
    # [960, 1086] (float32 operations), 0.0202 ms for the halo at one card
    assert work.correlator(64, 65536) * 1e3 == pytest.approx(0.0652, rel=2e-3)
    assert work.viterbi(960, 1086) * 1e3 == pytest.approx(0.0080, rel=5e-3)
    assert work.halo(8, 8 * 65872, 8, 65872 + 2687) * 1e3 == pytest.approx(0.0202, rel=2e-2)
    # twice the lags, twice the time; a bandwidth-bound stage counts bytes
    assert work.correlator(128, 65536) == pytest.approx(2 * work.correlator(64, 65536), rel=1e-6)
    assert work.halo(8, 1000, 2, 600) == pytest.approx((8 * 1000 + 2 * 8 * 600) * 8 / 3.35e12)


def _ev(name, a, b):
    return trace.Event(name, a, b)


def test_trace_summary_on_a_synthetic_trace():
    spans = [_ev("entry", 0.0, 0.002), _ev("fetch", 0.002, 0.010),
             _ev("entry", 0.010, 0.012), _ev("fetch", 0.012, 0.020)]
    device = [_ev("Memcpy HtoD (Pinned -> Device)", 0.001, 0.003),
              _ev("void correlate_kernel<5>(float2 const*, int)", 0.003, 0.004),
              _ev("void at::native::elementwise_kernel<128, 4>(int)", 0.0035, 0.008),
              _ev("viterbi_kernel(float2 const*)", 0.013, 0.018),
              # placed past the last span's end, as the trace's clocks allow
              _ev("void correlate_kernel<5>(float2 const*, int)", 0.019, 0.0205)]
    s = trace.summarize(device, spans, chunks=2)
    assert s.window_s == pytest.approx(0.0205)
    assert s.busy_s == pytest.approx(0.007 + 0.005 + 0.0015)
    assert s.kernels == 4  # the copy is no kernel; every kernel of the profile counts
    assert s.kernel_time({"correlate_kernel"}) == (2, pytest.approx(0.001 + 0.0015))
    assert s.gaps[0] == ("fetch", pytest.approx(0.005))  # 0.008 .. 0.013
    labels = {g[0] for g in s.gaps}
    assert labels <= {"entry", "fetch", "host"}
    assert sum(g[1] for g in s.gaps) == pytest.approx(s.window_s - s.busy_s)
    b = s.breakdown()
    assert [o[0] for o in b["device_ops"][:2]] == ["viterbi_kernel", "at::native::elementwise_kernel"]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_short_names_and_name_lists():
    assert trace.short_name("void ns::foo<1, 2>(float*, int)") == "ns::foo"
    assert trace.short_name("halo_kernel(float2 const*)") == "halo_kernel"
    for stage in work.STAGES:
        assert trace.kernel_names(stage), stage


def _record(**kw):
    cell = types.SimpleNamespace(traffic={"entry": "stream_step"})
    base = dict(cell=cell, chunk_samples=4_194_304, setup_s=7.5, window_s=10.0,
                latencies=[0.010] * 95 + [0.020] * 5,
                spans={"entry": [0.001, 0.002, 0.003]}, n_chunks=1000,
                stage_work={"correlator": [(64, 65536)] * 4, "viterbi": [(860, 1086), (861, 1086)]},
                trace=None)
    base.update(kw)
    return run.Record(**base)


def test_readers_on_a_record():
    from rxbench.metrics import (chunk_latency_ms_p95, correlator_roofline, device_ms_per_chunk,
                                 entry_call_ms_p50, halo_roofline, kernels_per_chunk,
                                 push_ms_per_chunk, rx_msamples_per_s, setup_s, viterbi_roofline)

    r = _record()
    assert rx_msamples_per_s.read(r) == pytest.approx(1000 * 4_194_304 / 10.0 / 1e6)
    assert chunk_latency_ms_p95.read(r) == pytest.approx(np.percentile([10.0] * 95 + [20.0] * 5, 95))
    assert setup_s.read(r) == 7.5
    assert entry_call_ms_p50.read(r) == pytest.approx(2.0)
    assert push_ms_per_chunk.read(r) is None
    for m in (device_ms_per_chunk, kernels_per_chunk, correlator_roofline, viterbi_roofline):
        assert m.read(r) is None  # no trace: nothing to read
    summ = trace.Summary(chunks=4, window_s=0.04, busy_s=0.03, kernels=400,
                         by_name={"correlate_kernel": [4, 4 * 3.0e-4],
                                  "viterbi_kernel": [2, 2 * 1.0e-4]}, gaps=[])
    r = _record(trace=summ)
    assert device_ms_per_chunk.read(r) == pytest.approx(7.5)
    assert kernels_per_chunk.read(r) == 100
    want = 100 * work.correlator(64, 65536) / 3.0e-4
    assert correlator_roofline.read(r) == pytest.approx(want)
    # the work of the frames the traced chunks carried, whatever the launches
    want = 100 * (work.viterbi(860, 1086) + work.viterbi(861, 1086)) / 2.0e-4
    assert viterbi_roofline.read(r) == pytest.approx(want)
    assert halo_roofline.read(r) is None  # no halo in this cell


def test_benchmark_json_is_complete():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert fr.load_config(c["name"]).name == c["name"]
        assert (ROOT / c["file"]).exists()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in bench["workloads"]:
        assert w["config"] in names and w["chips"] == 1
        cell = spec.load_cell(w["name"])
        assert "setup_s" in {m.name for m in cell.end_to_end} and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            moved = next(p["moves"] for p in bench["per_layer"] if p["name"] == m.name)
            assert moved in {e.name for e in cell.end_to_end}, (w["name"], m.name)
        assert set(cell.limits) == set(compare.Differences().numbers()) & set(cell.limits)
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
        assert m["moves"] in e2e


def test_slots_and_shapes_of_the_cells():
    cells = {w: spec.load_cell(w) for w in ("v27golay.chunks", "uncoded.chunks",
                                             "v27golay.push4096", "v27golay.sharded8")}
    slots = {w: c.entry.slots(c.config, c.traffic) for w, c in cells.items()}
    assert slots == {"v27golay.chunks": 15, "uncoded.chunks": 36, "v27golay.push4096": 15,
                     "v27golay.sharded8": 16}
    sh = cells["v27golay.sharded8"]
    shapes = sh.entry.shapes(sh.config, sh.traffic, 860)
    assert shapes["halo"] == (8, 526976, 8, 65872 + 2687)
    assert shapes["viterbi"] == (860, 1086)  # the frames carried, not 8 x 8 x 16 slots
    assert shapes["correlator"] == (8, 524288)  # a lag a new sample
    for c in cells.values():  # every cell hands 4,194,304 samples a chunk
        assert c.traffic["batch"] * c.traffic["chunk_len"] == 4_194_304
        assert c.entry.shapes(c.config, c.traffic, 1)["correlator"] == (
            c.traffic["batch"], c.traffic["chunk_len"])


@pytest.mark.parametrize("config", ["qpsk_v27_golay24", "qpsk_uncoded"])
def test_frames_by_chunk_counts_every_frame_once(config):
    from rxbench import windows

    cfg = fr.load_config(config)
    layout = fr.circle_layout(cfg, 64, 8 * 65536)
    kept = windows.frames_by_chunk(layout, cfg.overlap, 65536)
    assert kept.shape == (8,) and kept.sum() == 64 * layout.frames_per_channel
    # about 64 x 65,536 / period a chunk: fewer than the slots provisioned
    assert abs(kept.mean() - 64 * 65536 / cfg.period) < 64
    assert kept.max() < 64 * fr.slots_for(cfg, 65536)


def test_account_counts_missing_duplicate_and_wrong():
    cfg = fr.load_config("qpsk_uncoded")
    layout = fr.circle_layout(cfg, 2, 3 * 8192)
    n = layout.frames_per_channel
    payload = np.arange(2 * n * 64, dtype=np.int64).reshape(2, n, 64).astype(np.uint8)
    user = np.zeros((2, n, 14), dtype=np.uint8)
    rows = np.repeat(np.arange(2), n)
    starts = layout.starts.reshape(-1)

    def frames(keep, offset=0, bad=()):
        pay = payload.reshape(-1, 64)[keep].copy()
        for k in bad:
            pay[k, 0] ^= 1
        return {"row": rows[keep], "abs": starts[keep] + offset, "payload": pay,
                "header_user": user.reshape(-1, 14)[keep],
                "payload_valid": np.ones(int(keep.sum()), dtype=bool)}

    everything = np.ones(2 * n, dtype=bool)
    lo, hi = 0, 3 * 8192
    assert compare.account([frames(everything)], layout, payload, user, lo, hi) == (2 * n, 0)
    assert compare.account([frames(everything, offset=1)], layout, payload, user, lo, hi) == (2 * n, 0)
    some = everything.copy()
    some[:3] = False
    assert compare.account([frames(some)], layout, payload, user, lo, hi) == (2 * n, 3)
    assert compare.account([frames(everything), frames(some)], layout, payload, user, lo, hi) \
        == (2 * n, 2 * n - 3)  # decoded twice is a failure
    assert compare.account([frames(everything, bad=(0, 5))], layout, payload, user, lo, hi) \
        == (2 * n, 2)
    assert compare.account([frames(everything, offset=7)], layout, payload, user, lo, hi) \
        == (2 * n, 4 * n)  # on no sent frame: every one missing and every decode extra


def test_differ_counts_and_gaps():
    base = {"row": np.array([0, 0, 1]), "pos": np.array([10, 500, 10]),
            "header_valid": np.array([1, 1, 1], bool), "payload_valid": np.array([1, 0, 1], bool),
            "modulation": np.ones(3, np.int32), "inner_code": np.zeros(3, np.int32),
            "outer_code": np.zeros(3, np.int32), "payload_len": np.full(3, 64, np.int32),
            "header_user": np.zeros((3, 14), np.uint8), "payload": np.zeros((3, 64), np.uint8),
            "evm": np.array([-20.0, -21.0, -22.0]), "rssi": np.zeros(3), "cfo": np.zeros(3)}
    got = {k: v.copy() for k, v in base.items()}
    got["evm"] = got["evm"] + np.array([0.0, 0.001, 0.002])
    got["payload"][2, 5] = 9
    d = compare.Differences()
    compare.differ(got, base, 1000, d)
    nums = d.numbers()
    assert nums["frames_differ"] == 1 and nums["evm_gap_max"] == pytest.approx(0.002)
    assert nums["evm_gap_p50"] == pytest.approx(0.001)
    missing = {k: v[:2] for k, v in base.items()}
    d = compare.Differences()
    compare.differ(missing, base, 1000, d)
    assert d.numbers()["frames_differ"] == 1
    ok, rows = compare.held({"a": 1.0, "b": 2.0}, {"a": 1.0})
    assert ok and rows == [("a", 1.0, 1.0)]
    assert not compare.held({"a": 1.5}, {"a": 1.0})[0]
