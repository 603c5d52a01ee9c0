"""The program layer of the PyTorch port (``core/program.py``): the
counterpart of the JAX package's jitted, cached programs, replayed as CUDA
graphs on a card. On the CPU the bodies run directly; these tests hold what
a graph needs of them there:

- no host sync: no ``.item()``, ``nonzero``, boolean-mask indexing or
  truth test of a tensor inside a ``StreamingRx`` step and superstep, a
  ``FlexRx`` front end and a payload group, for (1,0,0) and (1,1,1); and,
  after a warm-up call has built every table, no ``torch.tensor``,
  ``torch.as_tensor`` or ``torch.from_numpy`` in a body (a copy from host
  memory, which stream capture refuses);
- the step with its window base as a device scalar equals the JAX
  package's ``StreamingRx`` over 3 chunks, a frame across each chunk edge;
- the program's bookkeeping: one body per static key, the launches a
  recorded capture made added back on each replay, outputs that a later
  call does not change.

Widths are a few thousand samples."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.runtime.stream import StreamingRx as JStreamingRx
from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.core import program as prog
from liquiddsp_tpu_torch.kernels import _cuda
from liquiddsp_tpu_torch.phy import framegen
from liquiddsp_tpu_torch.runtime import blocks
from liquiddsp_tpu_torch.runtime.blocks import FlexRx
from liquiddsp_tpu_torch.runtime.stream import StreamingRx

aten = torch.ops.aten
SYNCS = {aten._local_scalar_dense, aten.item, aten.is_nonzero, aten.nonzero, aten.masked_select}
HOST_COPIES = ("tensor", "as_tensor", "from_numpy")
CHUNK = 4096
EXACT = ("mask", "header_valid", "payload_valid", "modulation", "inner_code", "outer_code",
         "payload_len", "header_user", "payload")
CLOSE = (("evm", 0.02), ("rssi", 1e-3), ("cfo", 1e-6))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class NoHostSync(TorchDispatchMode):
    """Fails on every operator that reads a device value back on the host,
    and on a copy of a Python number into a tensor element (``t[i] = 1.0``:
    on a card, a copy from host memory)."""

    def __init__(self):
        super().__init__()
        self.lifted = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        assert func.overloadpacket not in SYNCS, f"host sync: {func}"
        assert not (func.overloadpacket in (aten.copy_, aten.index_put_)
                    and any(id(a) in self.lifted for a in args[1:])), f"host copy: {func}"
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket is aten.lift_fresh:
            self.lifted.add(id(out))
        return out


class HostCopies:
    """Counts the calls of torch.tensor / as_tensor / from_numpy while active."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in HOST_COPIES:
            real = getattr(torch, name)

            def counting(*a, _real=real, _name=name, **kw):
                self.calls.append(_name)
                return _real(*a, **kw)

            monkeypatch.setattr(torch, name, counting)


def frames_stream(cfg, starts, total, rows=2, snr_db=25.0, seed=0):
    """[rows, total] complex64: a frame of ``cfg`` at each of ``starts`` in
    every row, plus AWGN; payloads from ``seed``."""
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (len(starts), cfg.payload_len), dtype=np.uint8)
    frames = framegen.framegen(torch.from_numpy(payloads), cfg, device="cpu").numpy()
    x = np.zeros((rows, total), dtype=np.complex128)
    for j, s in enumerate(starts):
        x[:, s : s + frames.shape[1]] = frames[j]
    sigma = np.sqrt(np.mean(np.abs(frames) ** 2) / (2 * 10 ** (snr_db / 10)))
    x += sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64), payloads, frames.shape[1]


@pytest.mark.parametrize("cfg_t", [(1, 0, 0, 64), (1, 1, 1, 64)])
def test_bodies_make_no_host_sync_and_no_host_copy(cfg_t, monkeypatch):
    cfg = FrameConfig(*cfg_t)
    f = framegen.frame_length(cfg)
    # a frame inside chunk 0, one across the edge of chunks 0 and 1
    x, _, _ = frames_stream(cfg, [200, CHUNK - f // 2], 3 * CHUNK)
    xt = torch.from_numpy(x)
    chunks = xt.reshape(2, 3, CHUNK)
    rx = StreamingRx(cfg, 2, CHUNK, device="cpu")
    flex = FlexRx(max_payload_len=64, max_frames_per_block=4, device="cpu")

    def calls():
        rx.reset()
        out = {"step": rx.step(chunks[:, 0]), "superstep": rx.superstep(chunks[:, 1:])}
        handle = flex.work_submit(xt[:, : 2 * CHUNK])
        _, syms_flat, evm_flat = handle[:3]
        slots = [0, 1, 4, 5]  # the first two slots of each row
        out["group"] = blocks._decode_group(cfg, syms_flat, evm_flat, slots, 65)
        out["packed"] = handle[3]
        key = (cfg, syms_flat.shape[0], len(slots), 65, torch.device("cpu"))
        return out, (key, syms_flat, evm_flat, torch.tensor(slots))

    calls()  # the warm-up: builds every device_const table
    with NoHostSync():
        out, (key, syms_flat, evm_flat, idx) = calls()
    copies = HostCopies(monkeypatch)
    rx.reset()
    rx.step(chunks[:, 0])
    rx.superstep(chunks[:, 1:])
    flex.work_submit(xt[:, : 2 * CHUNK])
    blocks._PAYLOAD.body(key)(syms_flat, evm_flat, idx)
    monkeypatch.undo()
    assert copies.calls == []
    # the calls decoded the frames they were given
    assert int(out["step"].payload_valid.sum()) == 2  # the frame in chunk 0, both rows
    assert int(out["superstep"].payload_valid.sum()) == 2  # the straddler, in window 1
    assert int(out["group"][:, -1].sum()) == 4  # both frames of the block, both rows


def detected(results) -> dict:
    """{(chunk, row, epoch + start): {field: value}} over every detected
    slot of per-chunk results of either package."""
    out = {}
    for i, r in enumerate(results):
        d = r.to_numpy() if hasattr(r, "to_numpy") else {
            k: np.asarray(getattr(r, k)) for k in EXACT + ("mask", "start", "evm", "rssi", "cfo")}
        for b, k in zip(*np.nonzero(d["mask"])):
            key = (i, int(b), int(r.epoch) + int(d["start"][b, k]))
            assert key not in out, key
            out[key] = {name: d[name][b, k] for name in EXACT + ("evm", "rssi", "cfo")}
    return out


def test_step_with_device_base_equals_jax():
    cfg_t = (1, 0, 0, 64)
    f = framegen.frame_length(FrameConfig(*cfg_t))
    # a frame across each of the two chunk edges, and one inside chunk 0
    starts = [300, CHUNK - f // 2, 2 * CHUNK - f // 3]
    x, payloads, _ = frames_stream(FrameConfig(*cfg_t), starts, 3 * CHUNK, rows=1)
    rx = StreamingRx(FrameConfig(*cfg_t), 1, CHUNK, device="cpu")
    got = detected([rx.step(torch.from_numpy(x[:, c * CHUNK : (c + 1) * CHUNK]))
                    for c in range(3)])
    jrx = JStreamingRx(JFrameConfig(*cfg_t), batch=1, chunk_len=CHUNK)
    ref = detected(jrx.run(x))
    assert got.keys() == ref.keys()
    for key in ref:
        for name in EXACT:
            np.testing.assert_array_equal(got[key][name], ref[key][name], err_msg=f"{name} {key}")
        for name, atol in CLOSE:
            assert abs(float(got[key][name]) - float(ref[key][name])) <= atol, (name, key)
    # every frame exactly once, at its start, with the payload that was sent
    valid = {k[2]: bytes(v["payload"]) for k, v in got.items() if v["payload_valid"]}
    assert valid == {s: bytes(p) for s, p in zip(starts, payloads)}


def test_one_body_per_static_key():
    cfg = FrameConfig(1, 0, 0, 64)
    x = torch.zeros((1, 3 * CHUNK), dtype=torch.complex64)
    rx = StreamingRx(cfg, 1, CHUNK, device="cpu")
    rx.step(x[:, :CHUNK])
    rx.step(x[:, CHUNK : 2 * CHUNK])
    rx.superstep(x[:, : 2 * CHUNK])
    rx.superstep(x[:, CHUNK:])
    rx.superstep(x)
    assert set(rx.program.bodies) == {
        ("step", rx.max_frames), ("superstep", rx.max_frames, 2, False),
        ("superstep", rx.max_frames, 3, False)}
    other = StreamingRx(cfg, 1, CHUNK, max_frames_per_chunk=3, device="cpu")
    other.run_adaptive(x, chunks_per_launch=3, k_buckets=(2,))
    assert ("superstep", 2, 3, True) in other.program.bodies
    assert ("step", rx.max_frames) not in other.program.bodies  # programs are per instance

    syms = torch.zeros((8, 1500), dtype=torch.complex64)
    evm = torch.full((8,), 0.1)
    before = set(blocks._PAYLOAD.bodies)
    for c in ((1, 0, 0, 64), (1, 0, 0, 64), (1, 1, 1, 64)):
        blocks._decode_group(FrameConfig(*c), syms, evm, [0, 3], 65)
    blocks._decode_group(FrameConfig(1, 0, 0, 64), syms, evm, [0, 3, 5], 65)
    cpu = torch.device("cpu")
    assert set(blocks._PAYLOAD.bodies) - before <= {
        (FrameConfig(1, 0, 0, 64), 8, 2, 65, cpu), (FrameConfig(1, 1, 1, 64), 8, 2, 65, cpu),
        (FrameConfig(1, 0, 0, 64), 8, 3, 65, cpu)}
    assert {(FrameConfig(1, 1, 1, 64), 8, 2, 65, cpu),
            (FrameConfig(1, 0, 0, 64), 8, 3, 65, cpu)} <= set(blocks._PAYLOAD.bodies)


class RecordedGraph:
    """Stands in for a captured CUDA graph: a replay doubles the static
    input into the static output, as the recorded kernels would."""

    def __init__(self, inputs, outputs):
        self.inputs, self.outputs, self.replays = inputs, outputs, 0

    def replay(self):
        self.outputs["y"].copy_(self.inputs[0] * 2)
        self.outputs["n"].fill_(self.inputs[1])
        self.replays += 1


def test_replay_adds_the_recorded_launches_and_clones_outputs():
    inputs = [torch.zeros(4), torch.zeros((), dtype=torch.int64)]
    outputs = {"y": torch.zeros(4), "n": torch.zeros((), dtype=torch.int64)}
    graph = RecordedGraph(inputs, outputs)
    p = prog.Program("test", lambda key: None)
    recorded = {k: 0 for k in _cuda.LAUNCHES}
    recorded.update(correlator=1, viterbi=2)
    p.graphs["k"] = prog.Captured(graph, inputs, outputs, recorded, 0.0)
    _cuda.reset_launches()
    replays = prog.STATS["replays"]
    a = p("k", torch.ones(4), 7, device=torch.device("cuda"))
    b = p("k", torch.full((4,), 3.0), 9, device=torch.device("cuda"))
    assert graph.replays == 2 and p.replays == 2 and prog.STATS["replays"] == replays + 2
    assert _cuda.LAUNCHES["correlator"] == 2 and _cuda.LAUNCHES["viterbi"] == 4
    assert _cuda.LAUNCHES["extract"] == 0
    # the first call's outputs are its own, not views of the static buffers
    assert torch.equal(a["y"], torch.full((4,), 2.0)) and int(a["n"]) == 7
    assert torch.equal(b["y"], torch.full((4,), 6.0)) and int(b["n"]) == 9
    with pytest.raises(ValueError, match="the key must fix every shape"):
        p("k", torch.ones(5), 7, device=torch.device("cuda"))
    _cuda.reset_launches()


def test_capture_moves_its_counts_off_the_launch_counters():
    _cuda.reset_launches()
    _cuda.LAUNCHES["recover"] = 5
    before = dict(_cuda.LAUNCHES)
    _cuda.LAUNCHES["recover"] += 1  # what a capture records
    _cuda.LAUNCHES["extract"] += 2
    delta = prog._launch_delta(before)
    assert _cuda.LAUNCHES == before
    assert delta["recover"] == 1 and delta["extract"] == 2 and delta["viterbi"] == 0
    _cuda.reset_launches()


def test_cpu_runs_the_body_with_ints_as_0dim_tensors():
    seen = []

    def make(key):
        def body(x, i):
            seen.append((i.dtype, i.dim()))
            return Pair(x + i, x * key)
        return body

    p = prog.Program("cpu", make)
    out = p(2, torch.ones(3), 5)
    assert seen == [(torch.int64, 0)]
    assert torch.equal(out.a, torch.full((3,), 6.0)) and torch.equal(out.b, torch.full((3,), 2.0))
    assert p.graphs == {}
    with pytest.raises(TypeError, match="a tensor or an int"):
        p(2, torch.ones(3), 0.5)


@dataclasses.dataclass
class Pair:
    a: torch.Tensor
    b: torch.Tensor
