"""The time-sharded receiver of the PyTorch port against the JAX package and
against the payloads sent, on the CPU (``device="cpu"``, ``devices=["cpu"]``).

Inputs are made from a seed with numpy and fed to both packages. Integer and
boolean results (masks, starts, bytes, the halo windows) must agree exactly;
the float statistics to the tolerances of ``tests/test_torch_framesync.py``.
The JAX sharded receiver is compiled once, for one config at a small size
(``n_time = 4``, ``T_local = 2048``), on 4 of the 8 virtual CPU devices."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.parallel import halo as jhalo
from liquiddsp_tpu.parallel import mesh as jmesh
from liquiddsp_tpu.phy import framegen as jframegen
from liquiddsp_tpu.phy import framesync as jsync
from liquiddsp_tpu.utils import metrics as jmetrics
from liquiddsp_tpu_torch import FrameConfig, dryrun_sharded
from liquiddsp_tpu_torch.kernels.halo import halo_windows, halo_windows_ref
from liquiddsp_tpu_torch.parallel import mesh as tmesh
from liquiddsp_tpu_torch.parallel.halo import shard_stream, sharded_framesync
from liquiddsp_tpu_torch.phy import framegen as tframegen
from liquiddsp_tpu_torch.phy import framesync as tsync
from liquiddsp_tpu_torch.runtime.distributed_stream import ShardedStreamingRx
from liquiddsp_tpu_torch.streams import long_stream
from liquiddsp_tpu_torch.utils import metrics as tmetrics

QPSK = (1, 0, 0, 64)
CLASSES = {"qpsk_v27_golay": (1, 1, 1, 64), "dqpsk": (5, 0, 0, 64), "qam64_rs": (10, 0, 2, 64)}


def t(a):
    return torch.from_numpy(np.array(a))


def cpu_mesh(n_time, n_ch=1):
    return tmesh.make_mesh(n_time=n_time, n_ch=n_ch, devices=["cpu"])


def awgn(rng, shape, sigma):
    return sigma * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))


def collect(res, row=0):
    """Sorted (start, payload bytes, payload_valid) of the detected slots."""
    d = res.to_numpy() if isinstance(res, tsync.FrameResults) else {
        k: np.asarray(getattr(res, k)) for k in ("mask", "start", "payload", "payload_valid")}
    return sorted(
        (int(d["start"][row, k]) + int(getattr(res, "epoch", 0)), bytes(d["payload"][row, k]),
         bool(d["payload_valid"][row, k]))
        for k in np.nonzero(d["mask"][row])[0])


# -- the kernel-holding module: kernels/halo.py --------------------------------


@pytest.mark.parametrize("b,n_time,t_local,ov", [(2, 4, 1536, 1051), (3, 8, 2688, 2687), (1, 2, 128, 1)])
def test_halo_windows_equal_jax_dma_window_and_ppermute_window(b, n_time, t_local, ov):
    """Exact. The JAX window function (the Pallas kernel in interpret mode,
    under a shard_map that holds it alone, not the receiver) pads the tail to a multiple
    of 128 and leaves shard 0's head in the last shard's tail for its caller
    to mask: the local copy and the first ``ov`` tail samples are compared,
    and the last tail against the zeros the caller's mask leaves."""
    rng = np.random.default_rng(b)
    x = awgn(rng, (b, n_time * t_local), 1.0).astype(np.complex64)
    got = halo_windows_ref(t(x), n_time, ov)
    assert got.shape == (n_time, b, t_local + ov) and got.dtype == torch.complex64
    assert halo_windows(t(x), n_time, ov).equal(got)  # a CPU tensor takes the plain version

    # the ppermute path's window, with numpy: [x_local | head of the right neighbour, 0 at the end]
    xs = x.reshape(b, n_time, t_local).transpose(1, 0, 2)
    heads = np.concatenate([xs[1:, :, :ov], np.zeros((1, b, ov), np.complex64)])
    np.testing.assert_array_equal(got.numpy(), np.concatenate([xs, heads], axis=-1))

    mesh = JMesh(np.array(jax.devices()[:n_time]), (jmesh.TIME_AXIS,))
    build = shard_map(
        lambda xl: jhalo._window_with_halo_dma(xl, ov, n_time), mesh=mesh,
        in_specs=P(None, jmesh.TIME_AXIS), out_specs=P(None, jmesh.TIME_AXIS), check_vma=False)
    w = np.asarray(jax.jit(build)(jnp.asarray(x))).reshape(b, n_time, -1).transpose(1, 0, 2)
    assert w.shape[-1] == t_local + -(-ov // 128) * 128
    np.testing.assert_array_equal(got.numpy()[:-1], w[:-1, :, : t_local + ov])
    np.testing.assert_array_equal(got.numpy()[-1, :, :t_local], w[-1, :, :t_local])
    np.testing.assert_array_equal(w[-1, :, t_local : t_local + ov], x[:, :ov])  # the wrap-around
    assert not got.numpy()[-1, :, t_local:].any()


@pytest.mark.parametrize("shape,n_time,ov", [((2, 10), 3, 1), ((2, 12), 3, 5), ((12,), 3, 1), ((2, 12), 0, 1)])
def test_halo_windows_reject_bad_shapes(shape, n_time, ov):
    with pytest.raises(ValueError):
        halo_windows(torch.zeros(shape, dtype=torch.complex64), n_time, ov)


def test_halo_windows_single_shard_and_zero_overlap():
    x = t(np.arange(24, dtype=np.float32).reshape(2, 12).astype(np.complex64))
    one = halo_windows_ref(x, 1, 4)
    assert one.shape == (1, 2, 16) and one[0, :, :12].equal(x) and not one[0, :, 12:].any()
    assert halo_windows_ref(x, 3, 0).equal(x.reshape(2, 3, 4).transpose(0, 1))


# -- the mesh ------------------------------------------------------------------


def test_mesh_shapes_and_cells():
    m = cpu_mesh(4)
    assert m.shape == {tmesh.TIME_AXIS: 4, tmesh.CH_AXIS: 1}
    assert (tmesh.TIME_AXIS, tmesh.CH_AXIS) == (jmesh.TIME_AXIS, jmesh.CH_AXIS)
    assert m.device == torch.device("cpu") and m.checked_device() == m.device
    assert tmesh.make_mesh(devices=["cpu"]).shape == {"time": 1, "ch": 1}
    assert tmesh.make_mesh(n_ch=2, devices=["cpu", "cpu"]).shape == {"time": 1, "ch": 2}
    for bad in (dict(n_time=0, devices=["cpu"]), dict(n_ch=0, devices=["cpu"]), dict(devices=[])):
        with pytest.raises(ValueError):
            tmesh.make_mesh(**bad)


def test_mesh_over_several_devices_in_one_process_is_refused():
    """Refused where the mesh is built, so no receiver ever sees one: a card
    is a process of its own (init_distributed)."""
    with pytest.raises(NotImplementedError, match="init_distributed"):
        tmesh.make_mesh(n_time=2, n_ch=1, devices=["cpu", "meta"])
    with pytest.raises(NotImplementedError, match="init_distributed"):
        tmesh.make_mesh(devices=["cuda:0", "cuda:1"])


def test_sharded_framesync_rejects_bad_arguments():
    x = torch.zeros((3, 4096), dtype=torch.complex64)
    with pytest.raises(ValueError, match="halo"):
        sharded_framesync(x, FrameConfig(*QPSK), cpu_mesh(2), halo="ppermute")
    gpu = tmesh.make_mesh(n_time=2, devices=["cuda:0"])
    with pytest.raises(ValueError, match="CPU mesh only"):  # no receiver on a card without its kernel
        sharded_framesync(x, FrameConfig(*QPSK), gpu, halo="copy")
    with pytest.raises(ValueError, match="ch axis"):
        sharded_framesync(x, FrameConfig(*QPSK), cpu_mesh(2, n_ch=2))
    with pytest.raises(ValueError, match="time shards"):
        sharded_framesync(x[:, :4095], FrameConfig(*QPSK), cpu_mesh(2))


# -- the slice as a whole: QPSK on a boundary-straddle stream, against JAX ------

N_TIME, T_LOCAL, K_SHARD = 4, 2048, 3


class Straddle:
    """Three frames in 4 x 2048 samples at 20 dB: one inside a shard, two
    across shard boundaries (the layout of tests/test_parallel.py, smaller)."""

    def __init__(self):
        self.jcfg, self.tcfg = JFrameConfig(*QPSK), FrameConfig(*QPSK)
        rng = np.random.default_rng(1)
        self.payloads = rng.integers(0, 256, (3, 64), dtype=np.uint8)
        frames = np.asarray(jframegen.framegen(jnp.asarray(self.payloads), self.jcfg))
        f = frames.shape[1]
        self.starts = [T_LOCAL - f // 2, 2 * T_LOCAL - 10, 3 * T_LOCAL + 300]
        x = np.zeros((1, N_TIME * T_LOCAL), np.complex128)
        for s, fr in zip(self.starts, frames):
            x[0, s : s + f] = fr
        sigma = np.sqrt(np.mean(np.abs(frames) ** 2) / (2 * 10 ** 2.0))
        self.x = (x + awgn(rng, x.shape, sigma)).astype(np.complex64)
        jm = jmesh.make_mesh(n_time=N_TIME, n_ch=1, devices=jax.devices()[:N_TIME])
        self.ref = jax.jit(
            lambda a: jhalo.sharded_framesync(a, self.jcfg, jm, max_frames_per_shard=K_SHARD)
        )(jhalo.shard_stream(jnp.asarray(self.x), jm))
        tm = cpu_mesh(N_TIME)
        self.got = sharded_framesync(
            shard_stream(t(self.x), tm), self.tcfg, tm, max_frames_per_shard=K_SHARD)
        self.got_copy = sharded_framesync(t(self.x), self.tcfg, tm, K_SHARD, halo="copy")


@pytest.fixture(scope="module")
def straddle():
    return Straddle()


def test_sharded_frames_found_once_where_they_were_put(straddle):
    got = collect(straddle.got)
    assert len(got) == 3
    for (s_got, p_got, valid), s_want, p_want in zip(got, straddle.starts, straddle.payloads):
        assert abs(s_got - s_want) <= 1 and valid and p_got == bytes(p_want)
    assert straddle.got.mask.shape == (1, N_TIME * K_SHARD)
    assert straddle.got.epoch == 0


@pytest.mark.parametrize(
    "field", ["mask", "header_valid", "payload_valid", "start", "modulation", "inner_code",
              "outer_code", "payload_len", "header_user", "payload"])
def test_sharded_discrete_fields_equal_jax_slot_by_slot(straddle, field):
    """Exact; ``mask``, validity and ``start`` on every slot (so shard i's K
    slots sit at columns i*K .. (i+1)*K - 1 in both), the decoded fields on
    the slots that hold a detection (the others decode noise)."""
    a, b = np.asarray(getattr(straddle.ref, field)), getattr(straddle.got, field).numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    if field in ("mask", "header_valid", "payload_valid", "start"):
        np.testing.assert_array_equal(a, b)
    else:
        m = np.asarray(straddle.ref.mask)
        np.testing.assert_array_equal(a[m], b[m])


@pytest.mark.parametrize("field,atol", [("evm", 0.02), ("rssi", 1e-3), ("cfo", 1e-6)])
def test_sharded_stats_close_to_jax(straddle, field, atol):
    """evm and rssi in dB (evm follows the symbols' 1e-3 relative differences
    between two float32 chains), cfo in rad/sample."""
    m = np.asarray(straddle.ref.mask)
    np.testing.assert_allclose(
        getattr(straddle.got, field).numpy()[m], np.asarray(getattr(straddle.ref, field))[m],
        atol=atol)


def test_sharded_symbols_close_to_jax(straddle):
    """2e-3 * max|symbols|, as for the block receiver."""
    m = np.asarray(straddle.ref.mask)
    ref = np.asarray(straddle.ref.symbols)
    np.testing.assert_allclose(straddle.got.symbols.numpy()[m], ref[m], atol=2e-3 * np.abs(ref[m]).max())


def test_halo_settings_give_identical_results(straddle):
    """On the CPU every setting builds the windows with the plain version."""
    for f in dataclasses.fields(straddle.got):
        a, b = getattr(straddle.got, f.name), getattr(straddle.got_copy, f.name)
        assert a.equal(b) if isinstance(a, torch.Tensor) else a == b, f.name


def test_link_metrics_equal_jax_on_the_same_results(straddle):
    """Counts exact; the dB sums are float32 sums of 3 values: rtol 1e-6."""
    jm = jmetrics.LinkMetrics.from_results(straddle.ref, 8192)
    as_torch = tsync.FrameResults(**{
        f.name: t(np.asarray(getattr(straddle.ref, f.name)))
        for f in dataclasses.fields(tsync.FrameResults) if f.name != "epoch"})
    tm = tmetrics.LinkMetrics.from_results(as_torch, 8192)
    for f in dataclasses.fields(tmetrics.LinkMetrics):
        a, b = np.asarray(getattr(jm, f.name)), getattr(tm, f.name).numpy()
        assert a.dtype == b.dtype and b.shape == (), f.name
        np.testing.assert_allclose(b, a, rtol=1e-6)
    assert (int(tm.frames_detected), int(tm.headers_valid), int(tm.payloads_valid)) == (3, 3, 3)
    own = tmetrics.LinkMetrics.from_results(straddle.got, 8192)
    assert int(own.frames_detected) == 3 and int(own.samples) == 8192


def test_metrics_collector_and_profile_trace(straddle, tmp_path):
    m = tmetrics.LinkMetrics.from_results(straddle.got, 8192)
    col = tmetrics.MetricsCollector()
    col.update(m)
    col.update(m)
    col.count_packet(1, 0, 0, True)
    col.count_packet(1, 0, 0, False)
    rep = col.report()
    assert rep["samples"] == 16384 and rep["frames_detected"] == 6 and rep["payloads_valid"] == 6
    assert rep["frame_success_rate"] == 1.0
    np.testing.assert_allclose(rep["mean_evm_db"], float(m.sum_evm_db) / 3, rtol=1e-6)
    assert col.num_received[1, 0, 0] == 2 and col.num_correct[1, 0, 0] == 1
    assert col.num_received.shape == (11, 7, 8)
    with tmetrics.profile_trace(None) as prof:
        assert prof is None
    with tmetrics.profile_trace(str(tmp_path / "trace")):
        torch.zeros(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


# -- the other config classes ---------------------------------------------------


def block_receiver_against_jax(cfg, snr_db, seed):
    """One [1, 4096] stream of two frames with a CFO and a phase through both
    framesync_fixed: masks, starts, validity and bytes exact, the statistics
    to the tolerances of the sharded comparison above."""
    jcfg, tcfg = JFrameConfig(*cfg), FrameConfig(*cfg)
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (2, 64), dtype=np.uint8)
    frames = np.asarray(jframegen.framegen(jnp.asarray(payloads), jcfg))
    np.testing.assert_allclose(  # TX: table phases against float32 exp(j phase)
        tframegen.framegen(t(payloads), tcfg, device="cpu").numpy(), frames, atol=2e-6)
    f = frames.shape[1]
    x = np.zeros((1, 4096), np.complex128)
    starts = [200, 300 + f + 600]
    for s, fr in zip(starts, frames):
        x[0, s : s + f] = fr * np.exp(1j * (0.01 * np.arange(f) + 1.0))
    sigma = np.sqrt(np.mean(np.abs(frames) ** 2) / (2 * 10 ** (snr_db / 10)))
    x = (x + awgn(rng, x.shape, sigma)).astype(np.complex64)
    ref = jax.jit(functools.partial(jsync.framesync_fixed, cfg=jcfg, max_frames=3))(jnp.asarray(x))
    got = tsync.framesync_fixed(t(x), tcfg, 3, device="cpu")
    for name in ("mask", "start", "header_valid", "payload_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)), getattr(got, name).numpy())
    pv = got.payload_valid.numpy()
    assert pv.sum() == 2
    np.testing.assert_array_equal(np.asarray(ref.payload)[pv], got.payload.numpy()[pv])
    assert [(s, p) for s, p, _ in collect(got)] == [
        (s, bytes(p)) for s, p in zip(starts, payloads)]
    m = np.asarray(ref.mask)
    for name, atol in (("evm", 0.02), ("rssi", 1e-3), ("cfo", 1e-6)):  # dB, dB, rad/sample
        np.testing.assert_allclose(
            getattr(got, name).numpy()[m], np.asarray(getattr(ref, name))[m], atol=atol)
    sym = np.asarray(ref.symbols)[m]
    np.testing.assert_allclose(got.symbols.numpy()[m], sym, atol=2e-3 * np.abs(sym).max())


def test_dqpsk_block_receiver_equals_jax():
    """(5,0,0) unsharded at 20 dB."""
    block_receiver_against_jax(CLASSES["dqpsk"], 20.0, 5)


def test_qam64_rs_block_receiver_equals_jax():
    """(10,0,2) unsharded at 30 dB: the QAM gain and phase tracking, the
    64-point soft demodulator and the Reed-Solomon decode inside the
    receiver."""
    block_receiver_against_jax(CLASSES["qam64_rs"], 30.0, 10)


class ClassCase:
    """One interior frame and one across a shard boundary, no noise (the
    layout of tests/test_parallel.py::test_matches_unsharded at n_time 4)."""

    def __init__(self, name):
        self.cfg = FrameConfig(*CLASSES[name])
        f = tframegen.frame_length(self.cfg)
        self.t_local = max(2048, ((2 * f + 800) // 256) * 256)
        rng = np.random.default_rng(2)
        self.payloads = rng.integers(0, 256, (2, 64), dtype=np.uint8)
        frames = tframegen.framegen(t(self.payloads), self.cfg, device="cpu")
        self.starts = [300, 2 * self.t_local - f // 2]
        x = torch.zeros((1, 4 * self.t_local), dtype=torch.complex64)
        for s, fr in zip(self.starts, frames):
            x[0, s : s + f] = fr
        self.unsharded = tsync.framesync_fixed(x, self.cfg, 8, device="cpu")
        self.sharded = sharded_framesync(x, self.cfg, cpu_mesh(4), max_frames_per_shard=4)


@pytest.fixture(scope="module", params=list(CLASSES))
def class_case(request):
    return ClassCase(request.param)


def test_class_sharded_matches_unsharded(class_case):
    assert collect(class_case.sharded) == collect(class_case.unsharded)


def test_class_sharded_decodes_what_was_sent(class_case):
    got = collect(class_case.sharded)
    assert [(s, p, v) for s, p, v in got] == [
        (s, bytes(p), True) for s, p in zip(class_case.starts, class_case.payloads)]
    for name, want in (("modulation", class_case.cfg.modulation),
                       ("inner_code", class_case.cfg.inner_code),
                       ("outer_code", class_case.cfg.outer_code)):
        pv = class_case.sharded.payload_valid
        assert (getattr(class_case.sharded, name)[pv] == want).all()


def test_dryrun_sharded_on_the_cpu(capsys):
    dryrun_sharded(2, device="cpu")
    out = capsys.readouterr().out
    assert "qpsk=6 frames" in out and "qam64_rs=6 frames" in out and "2 boundary straddles" in out


# -- streaming -----------------------------------------------------------------


class Streamed:
    """The five placements of tests/test_distributed_stream.py, three chunks
    of 16384 through an 8-shard ShardedStreamingRx."""

    def __init__(self):
        cfg = FrameConfig(*QPSK)
        rng = np.random.default_rng(0)
        self.payloads = rng.integers(0, 256, (5, 64), dtype=np.uint8)
        frames = tframegen.framegen(t(self.payloads), cfg, device="cpu").numpy()
        f = frames.shape[1]
        chunk = 16384
        shard_len = (chunk + f - 1 + ((-(chunk + f - 1)) % 8)) // 8
        self.starts = [
            1000,                    # mid first shard
            shard_len * 3 - f // 2,  # shard boundary inside block 1
            chunk - f // 2,          # super-block 1 -> 2 boundary
            2 * chunk - f + 37,      # super-block 2 -> 3 boundary (tail)
            2 * chunk + 5000,        # inside block 3
        ]
        stream = np.zeros((1, 3 * chunk), np.complex64)
        for s, fr in zip(self.starts, frames):
            stream[0, s : s + f] += fr
        self.rx = ShardedStreamingRx(cfg, cpu_mesh(8), batch=1, chunk_len=chunk,
                                     max_frames_per_shard=4)
        self.run1 = self.run(stream, chunk)
        self.rx.reset()
        self.run2 = self.run(stream, chunk)
        self.chunk = chunk

    def run(self, stream, chunk):
        got, counts, epochs = [], [], []
        for pos in range(0, stream.shape[1], chunk):
            res, m = self.rx.step(t(stream[:, pos : pos + chunk]))
            got += collect(res)
            counts.append((int(m.frames_detected), int(m.headers_valid), int(m.payloads_valid),
                           int(m.samples)))
            epochs.append(res.epoch)
        return sorted(got), counts, epochs


@pytest.fixture(scope="module")
def streamed():
    return Streamed()


def test_streaming_decodes_every_frame_once(streamed):
    got, _, epochs = streamed.run1
    assert len(got) == 5 and epochs == [0, 0, 0]
    for (s_got, p_got, valid), idx in zip(got, np.argsort(streamed.starts)):
        assert abs(s_got - streamed.starts[idx]) <= 1 and valid
        assert p_got == bytes(streamed.payloads[idx])


def test_streaming_metrics_equal_the_jax_counts(streamed):
    """tests/test_distributed_stream.py runs this stream through the JAX
    ShardedStreamingRx and counts 5 detected frames in all; per step (read
    off that run) 2, 1 and 2, every one with a valid header and payload; each
    step's window is 16384 + 1051 samples padded to a multiple of 8."""
    _, counts, _ = streamed.run1
    assert counts == [(2, 2, 2, 17440), (1, 1, 1, 17440), (2, 2, 2, 17440)]
    assert sum(c[0] for c in counts) == 5


def test_streaming_reset_starts_a_new_stream(streamed):
    assert streamed.run2 == streamed.run1


def test_streaming_rejects_bad_chunks_and_small_shards(streamed):
    with pytest.raises(ValueError, match="expected shape"):
        streamed.rx.step(torch.zeros((1, 100), dtype=torch.complex64))
    with pytest.raises(ValueError, match="chunk too small"):
        ShardedStreamingRx(FrameConfig(*QPSK), cpu_mesh(8), batch=1, chunk_len=4096)


def test_streaming_epoch_keeps_start_within_int32():
    """Past 2^30 samples ``start`` is relative to the result's ``epoch``."""
    cfg = FrameConfig(*QPSK)
    rx = ShardedStreamingRx(cfg, cpu_mesh(2), batch=1, chunk_len=4096, max_frames_per_shard=3)
    payload = np.arange(64, dtype=np.uint8)[None]
    frame = tframegen.framegen(t(payload), cfg, device="cpu")
    chunk = torch.zeros((1, 4096), dtype=torch.complex64)
    chunk[0, 500 : 500 + frame.shape[1]] = frame[0]
    rx._consumed = (1 << 30) + 4096 * 3  # as if 2^30 samples had gone by
    res, _ = rx.step(chunk)
    assert res.epoch == 1 << 30 and rx.start_epoch == 1 << 30
    (s, p, v), = collect(res)
    assert s == (1 << 30) + 4096 * 3 + 500 and v and p == bytes(payload[0])
    assert res.start.dtype == torch.int32


# -- the long stream -----------------------------------------------------------


def test_long_stream_layout_and_decode():
    cfg = FrameConfig(*QPSK)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    x, payloads, starts, whole = long_stream(cfg, 20.0, 4, 8 * 2048, gen, device="cpu")
    f, period = 1052, 37 + 1052 + 841
    assert x.shape == (4, 16384) and x.dtype == torch.complex64
    assert payloads.shape == (4, 9, 64) and payloads.dtype == torch.uint8
    assert starts[:, 0].tolist() == [37 + b * period // 4 for b in range(4)]
    assert (starts[:, 1:] - starts[:, :-1] == period).all()
    assert whole.equal(starts + f <= 16384) and 30 <= int(whole.sum()) < 36
    assert len({bytes(p) for p in payloads.reshape(-1, 64).numpy()}) == 36  # all different
    res = sharded_framesync(x, cfg, cpu_mesh(8), max_frames_per_shard=4)
    for b in range(4):
        got = [(s, p) for s, p, v in collect(res, b) if v]
        want = [(int(s), bytes(p.numpy())) for s, p, w in zip(starts[b], payloads[b], whole[b]) if w]
        assert len(got) == len(want)
        for (sg, pg), (sw, pw) in zip(got, want):
            assert abs(sg - sw) <= 1 and pg == pw
    # some frame of some row runs across a shard boundary
    assert bool((whole & (starts % 2048 > 2048 - f)).any())
