"""The runtime blocks of the PyTorch port (FlexTx, FlexRx, FrameDetectorCC),
its message bus and its simulation blocks, against the JAX package.

The FlexRx cases are those of tests/test_runtime.py (mixed configs at
max_payload_len 64, 40 and 48; grouped decode; speculative parity): the
port's packet_info dicts equal the JAX FlexRx's field by field (integers and
payload bytes exact; evm 0.02 dB, rssi 1e-3 dB, cfo 1e-6 rad/sample). At
max_payload_len 64 the receiver's buffer is 2416 symbols, so every frame
takes the sample-clock-drift path."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.phy import framegen as jframegen
from liquiddsp_tpu.runtime import blocks as jblocks
from liquiddsp_tpu.runtime import sim as jsim
from liquiddsp_tpu_torch.phy import framegen as tframegen
from liquiddsp_tpu_torch.phy import frame_spec as tfs
from liquiddsp_tpu_torch.runtime import blocks, sim
from liquiddsp_tpu_torch.runtime.bus import PDU, MessageBus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's tests: the suite runs in several
    worker processes at once, and torch's default of a thread a core
    oversubscribes them (alone, these tests run as fast on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EXACT = ("header_valid", "payload_valid", "modulation", "inner_code", "outer_code",
         "payload_len", "start", "batch")
CLOSE = (("evm", 0.02), ("rssi", 1e-3), ("cfo", 1e-6))


def frame(payload, cfg):
    return np.array(jframegen.framegen(jnp.asarray(payload), JFrameConfig(*cfg)))


def assert_infos_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in EXACT:
            assert g[k] == r[k], (k, g[k], r[k])
            assert type(g[k]) is type(r[k]), k
        np.testing.assert_array_equal(np.asarray(g["payload"]), np.asarray(r["payload"]))
        assert np.asarray(g["payload"]).dtype == np.uint8
        for k, atol in CLOSE:
            assert abs(g[k] - r[k]) <= atol, (k, g[k], r[k])


def mixed_block():
    """tests/test_runtime.py's two-config block: QPSK/64 and QAM16 + V27 +
    Hamming(7,4)/32 in one row."""
    rng = np.random.default_rng(2)
    pa = rng.integers(0, 256, (1, 64), dtype=np.uint8)
    pb = rng.integers(0, 256, (1, 32), dtype=np.uint8)
    fa, fb = frame(pa, (1, 0, 0, 64)), frame(pb, (8, 1, 3, 32))
    x = np.zeros((1, 10000), dtype=np.complex64)
    x[0, 200 : 200 + fa.shape[1]] = fa
    x[0, 6000 : 6000 + fb.shape[1]] = fb
    return x, pa[0], pb[0]


def test_flex_rx_self_describing_mixed_configs():
    x, pa, pb = mixed_block()
    rx = blocks.FlexRx(max_payload_len=64, device="cpu")
    assert rx.n_syms == 2416 >= 2200  # the sample-clock-drift path
    infos = rx.work(x)
    assert [(d["modulation"], d["inner_code"], d["outer_code"]) for d in infos] == [(1, 0, 0), (8, 1, 3)]
    assert all(d["payload_valid"] for d in infos)
    np.testing.assert_array_equal(infos[0]["payload"], pa)
    np.testing.assert_array_equal(infos[1]["payload"], pb)
    assert_infos_equal(infos, jblocks.FlexRx(max_payload_len=64).work(x))


def test_flex_rx_batched_group_decode():
    """Frames sharing a config across channels decode as one group; mixed
    groups and odd group sizes come back bit-exact in (batch, start) order."""
    rng = np.random.default_rng(7)
    cfg_a, cfg_b = (1, 0, 0, 40), (4, 2, 0, 40)
    n_ch, t = 3, 12000
    x = np.zeros((n_ch, t), dtype=np.complex64)
    sent = {}
    for c in range(n_ch):
        p1 = rng.integers(0, 256, (1, 40), dtype=np.uint8)
        p2 = rng.integers(0, 256, (1, 40), dtype=np.uint8)
        c2 = cfg_a if c == 2 else cfg_b
        f1, f2 = frame(p1, cfg_a), frame(p2, c2)
        s1, s2 = 150 + 37 * c, 6200 + 53 * c
        x[c, s1 : s1 + f1.shape[1]] = f1
        x[c, s2 : s2 + f2.shape[1]] = f2
        sent[(c, s1)] = (cfg_a[:3], p1[0])
        sent[(c, s2)] = (c2[:3], p2[0])
    rx = blocks.FlexRx(max_payload_len=40, device="cpu")
    infos = rx.work(torch.from_numpy(x))
    assert len(infos) == 6 and rx.num_packets == 6
    order = [(d["batch"], d["start"]) for d in infos]
    assert order == sorted(order)
    for d in infos:
        key = min(sent, key=lambda s: abs(s[1] - d["start"]) + 10000 * (s[0] != d["batch"]))
        assert (d["modulation"], d["inner_code"], d["outer_code"]) == sent[key][0]
        assert d["payload_valid"]
        np.testing.assert_array_equal(d["payload"], sent[key][1])
    assert_infos_equal(infos, jblocks.FlexRx(max_payload_len=40).work(x))


def test_flex_rx_speculative_decode_parity():
    """work_submit(expected_configs=...) returns the infos of the plain path
    (and of the JAX FlexRx) when the expectation is confirmed, when it is
    wrong for a channel, and without one."""
    rng = np.random.default_rng(21)
    pa = rng.integers(0, 256, (1, 48), dtype=np.uint8)
    pb = rng.integers(0, 256, (1, 48), dtype=np.uint8)
    fa, fb = frame(pa, (1, 0, 0, 48)), frame(pb, (8, 1, 3, 48))
    x = np.zeros((2, 8000), dtype=np.complex64)
    x[0, 200 : 200 + fa.shape[1]] = fa
    x[1, 500 : 500 + fb.shape[1]] = fb
    base = jblocks.FlexRx(max_payload_len=48).work(x)
    assert len(base) == 2 and all(d["payload_valid"] for d in base)
    for expected in ([(1, 0, 0, 48), (8, 1, 3, 48)], [(4, 2, 0, 48), (8, 1, 3, 48)], None):
        rx = blocks.FlexRx(max_payload_len=48, device="cpu")
        assert_infos_equal(rx.work_complete(rx.work_submit(x, expected_configs=expected)), base)


def test_flex_rx_ports():
    """constellation (every detected slot, only when subscribed),
    payload_data (valid payloads) and packet_info (every header-valid slot)."""
    x, pa, pb = mixed_block()
    bus = MessageBus()
    rx = blocks.FlexRx(max_payload_len=64, bus=bus, device="cpu")
    got = {"constellation": [], "payload_data": [], "packet_info": []}
    for port, seen in got.items():
        bus.subscribe(port, seen.append)
    bus.publish("stream_in", x)
    assert len(got["constellation"]) == 2
    assert got["constellation"][0].data.shape == (rx.n_syms,)
    assert len(got["payload_data"]) == 2 and len(got["packet_info"]) == 2
    assert sorted(bytes(p.data) for p in got["payload_data"]) == sorted([bytes(pa), bytes(pb)])


def test_flex_tx_emits_frames_and_reconfigures():
    bus = MessageBus()
    tx = blocks.FlexTx(modulation=1, bus=bus, device="cpu")
    seen = []
    bus.subscribe("pdus", seen.append)
    payload = np.zeros((1, 64), dtype=np.uint8)
    tx.send_pkt(PDU(meta={}, data=payload))
    assert tx.num_frames == 1 and seen[0].meta["modulation"] == 1
    # the waveform to tests/test_torch_framegen.py's atol 1e-6 (29-tap sums)
    np.testing.assert_allclose(seen[0].data.numpy(), frame(payload, (1, 0, 0, 64)), atol=1e-6)
    tx.configure({"modulation": 0, "inner_code": 1, "outer_code": 1})
    bus.publish("pdus_in", PDU(meta={}, data=payload[0]))  # one payload, 1-D
    assert seen[1].data.shape == (1, tfs.FrameSpec(tfs.FrameConfig(0, 1, 1, 64)).frame_samples)
    assert seen[1].data.shape[-1] > seen[0].data.shape[-1]  # lower rate, longer frame
    assert tx.num_frames == 2


@pytest.mark.parametrize("field,bad,fallback", [("modulation", 99, 0), ("inner_code", 7, 0),
                                                ("outer_code", -1, 0)])
def test_flex_tx_rejects_bad_config(field, bad, fallback):
    tx = blocks.FlexTx(modulation=3, inner_code=2, outer_code=2, device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tx.configure({field: bad})
    assert getattr(tx, field) == fallback
    assert any("Unsupported" in str(m.message) for m in w)


def test_frame_detector_block():
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, (1, 64), dtype=np.uint8)
    f = frame(payload, (1, 0, 0, 64))
    x = np.zeros((1, 4096), dtype=np.complex64)
    x[0, 1000 : 1000 + f.shape[1]] = f
    blk = blocks.FrameDetectorCC(device="cpu")
    out, det = blk.work(x)
    assert blk.num_frames == 1
    np.testing.assert_array_equal(out.numpy(), x)  # passthrough
    _, jdet = jblocks.FrameDetectorCC().work(x)
    np.testing.assert_array_equal(det.mask.numpy(), np.asarray(jdet.mask))
    np.testing.assert_array_equal(det.start.numpy(), np.asarray(jdet.start))


def test_message_bus():
    bus = MessageBus()
    got = []
    assert not bus.has_subscribers("a")
    bus.subscribe("a", got.append)
    bus.subscribe("a", lambda m: got.append(("second", m)))
    assert bus.has_subscribers("a")
    bus.publish("a", 1)
    bus.post("a", 2)
    bus.post("b", 3)  # nobody listens
    assert got == [1, ("second", 1)]
    assert bus.drain(max_messages=1) == 1 and got[-1] == ("second", 2)
    assert bus.drain() == 1
    pdu = PDU(meta={"n": 1}, data=b"x")
    assert (pdu.meta, pdu.data) == ({"n": 1}, b"x")


def test_packet_source_draws_the_reference_payloads():
    a, b = sim.PacketSource(payload_len=24, seed=5), jsim.PacketSource(payload_len=24, seed=5)
    for _ in range(3):
        np.testing.assert_array_equal(a.step().data, b.step().data)
    assert len(a.sent) == 3 and a.sent[0].shape == (24,)


@pytest.mark.parametrize("snr_db", [0.0, 12.0])
def test_channel_model_noise_power(snr_db):
    """The noise is the seeded generator's, not jax.random's: its power
    lies within 5 % of what the SNR asks, and the frames sit at the offset."""
    frames = torch.from_numpy(frame(np.zeros((2, 64), np.uint8), (1, 0, 0, 64)))
    ch = sim.ChannelModel(snr_db=snr_db, pad=4096, offset=512, seed=1, device="cpu")
    y = ch.apply(PDU(meta={}, data=frames))
    assert y.shape == (2, frames.shape[1] + 4096) and y.dtype == torch.complex64
    noise = torch.cat([y[:, :512], y[:, 512 + frames.shape[1]:]], dim=1)
    p_sig = float(torch.mean(torch.abs(frames) ** 2))
    p_noise = float(torch.mean(torch.abs(noise) ** 2))
    assert abs(p_noise / (p_sig / 10 ** (snr_db / 10)) - 1) < 0.05
    ch.set_snr(snr_db + 10)
    y2 = ch.apply(frames)
    assert float(torch.mean(torch.abs(y2[:, :512]) ** 2)) < 0.2 * p_noise
