"""The continuous streaming receiver of the PyTorch port (``StreamingRx``)
against the JAX package's, on the CPU, on the same numpy streams.

The streams are the cases of tests/test_runtime.py (a straddle, several
frames, a frame straddling every chunk boundary, a bursty and a sparse
stream for ``run_adaptive``), with AWGN at 25 dB so that the statistics are
well defined. The first three are rows of one [3, 6 x 2048] stream, so the
JAX receiver compiles its step once; each JAX run happens once, in a module
fixture. Results are compared by chunk and absolute index (``epoch +
start``): the discrete fields and the payload bytes exactly, evm within 0.02
dB, rssi 1e-3 dB, cfo 1e-6 rad/sample (the tolerances of
tests/test_torch_framesync.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.phy import framegen as jframegen
from liquiddsp_tpu.runtime.stream import StreamingRx as JStreamingRx
from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.runtime.stream import K_BUCKETS, StreamingRx, split_results

CFG = (1, 0, 0, 64)
CHUNK, N_CHUNKS = 2048, 6
EXACT = ("mask", "header_valid", "payload_valid", "modulation", "inner_code", "outer_code",
         "payload_len", "header_user", "payload")
CLOSE = (("evm", 0.02), ("rssi", 1e-3), ("cfo", 1e-6))
# the stream crosses 2^30 in its fourth chunk; the fifth window starts past it
EPOCH_PRESET = (1 << 30) - 3 * CHUNK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames_of(payloads):
    return np.asarray(jframegen.framegen(jnp.asarray(payloads), JFrameConfig(*CFG)))


def noisy(x, rng, frames, snr_db=25.0):
    sigma = np.sqrt(np.mean(np.abs(frames) ** 2) / (2 * 10 ** (snr_db / 10)))
    return (x + sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))).astype(
        np.complex64)


def main_stream():
    """Row 0: one frame straddling the first boundary. Row 1: three frames,
    one across the third boundary. Row 2: one frame straddling EVERY
    internal boundary plus one at 300. Returns (x, {row: [(start, bytes)]})."""
    rng = np.random.default_rng(0)
    payloads = rng.integers(0, 256, (8, 64), dtype=np.uint8)
    frames = frames_of(payloads)
    f = frames.shape[1]
    x = np.zeros((3, N_CHUNKS * CHUNK), dtype=np.complex128)
    placed = {
        0: [CHUNK - f // 2],
        1: [100, CHUNK + 700, 3 * CHUNK - f // 3],
        2: [300] + [CHUNK * (i + 1) - f // 2 for i in range(N_CHUNKS - 1)],
    }
    sent, j = {}, 0
    for row, starts in placed.items():
        sent[row] = []
        for s in starts:
            x[row, s : s + f] = frames[j % 8]
            sent[row].append((s, bytes(payloads[j % 8])))
            j += 1
    return noisy(x, rng, frames), sent


def bursty_stream(chunk=8192, n=6):
    """tests/test_runtime.py's: sparse frames early, then five back to back
    in chunk 3, which overflow a small bucket."""
    rng = np.random.default_rng(21)
    payloads = rng.integers(0, 256, (8, 64), dtype=np.uint8)
    frames = frames_of(payloads)
    f = frames.shape[1]
    x = np.zeros((1, chunk * n), dtype=np.complex128)
    placed = []
    for i, s in enumerate([300, chunk - f // 2, 2 * chunk + 500]):
        x[0, s : s + f] = frames[i]
        placed.append((s, bytes(payloads[i])))
    s = 3 * chunk + 200
    for j in range(3, 8):
        x[0, s : s + f] = frames[j]
        placed.append((s, bytes(payloads[j])))
        s += f + 10
    return noisy(x, rng, frames), placed


def sparse_stream(chunk=4096, n=6):
    """One frame a chunk at 700: demand 1-2 a window."""
    rng = np.random.default_rng(5)
    payloads = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    frames = frames_of(payloads)
    f = frames.shape[1]
    x = np.zeros((1, chunk * n), dtype=np.complex128)
    for i in range(n):
        x[0, i * chunk + 700 : i * chunk + 700 + f] = frames[i]
    return noisy(x, rng, frames), n


def detected(results) -> dict:
    """{(result index, row, epoch + start): {field: value}} over every
    detected slot of a list of per-chunk results (either package)."""
    out = {}
    for i, r in enumerate(results):
        d = r.to_numpy() if hasattr(r, "to_numpy") else {
            k: np.asarray(getattr(r, k)) for k in EXACT + ("start", "evm", "rssi", "cfo")}
        for b, k in zip(*np.nonzero(d["mask"])):
            key = (i, int(b), int(r.epoch) + int(d["start"][b, k]))
            assert key not in out, key
            out[key] = {name: d[name][b, k] for name in EXACT + ("evm", "rssi", "cfo")}
    return out


def assert_same(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    assert got, "no frame detected"
    for key in ref:
        for name in EXACT:
            np.testing.assert_array_equal(got[key][name], ref[key][name], err_msg=f"{name} {key}")
        for name, atol in CLOSE:
            assert abs(float(got[key][name]) - float(ref[key][name])) <= atol, (name, key)


def valid_frames(results) -> dict:
    """{absolute start: payload bytes} of the payload-valid slots (row 0)."""
    return {k[2]: bytes(v["payload"]) for k, v in detected(results).items()
            if v["payload_valid"] and k[1] == 0}


def port_rx(chunk=CHUNK, batch=3, **kw):
    return StreamingRx(FrameConfig(*CFG), batch=batch, chunk_len=chunk, device="cpu", **kw)


def push_pieces(rx, x, jax_arrays):
    """``x`` in 256-sample pieces, every other one as a device array of its
    package, then ``flush``."""
    results = []
    for j, pos in enumerate(range(0, x.shape[1], 256)):
        piece = x[:, pos : pos + 256]
        if j % 2:
            piece = jnp.asarray(piece) if jax_arrays else torch.from_numpy(piece)
        results.extend(rx.push(piece))
    tail = rx.flush()
    return results + ([tail] if tail is not None else [])


@pytest.fixture(scope="module")
def main_case():
    """The JAX receiver's results on the main stream: run, 256-sample
    pushes, and run after a stream position preset just below 2^30."""
    x, sent = main_stream()
    jrx = JStreamingRx(JFrameConfig(*CFG), batch=3, chunk_len=CHUNK)
    ref = {"run": detected(jrx.run(x))}
    jrx.reset()
    ref["push"] = detected(push_pieces(jrx, x, jax_arrays=True))
    jrx.reset()
    jrx._samples_consumed = EPOCH_PRESET
    ref["epoch"] = detected(jrx.run(x))
    return x, sent, ref


def test_run_equals_jax_on_straddle_and_several_frames(main_case):
    x, sent, ref = main_case
    got = detected(port_rx().run(x))
    assert_same(got, ref["run"])
    # and against what was sent: every frame exactly once, bit-exact
    for row, frames in sent.items():
        mine = sorted((k[2], bytes(v["payload"])) for k, v in got.items()
                      if k[1] == row and v["payload_valid"])
        assert len(mine) == len(frames), (row, mine)
        for (s_got, p_got), (s_want, p_want) in zip(mine, sorted(frames)):
            assert abs(s_got - s_want) <= 1 and p_got == p_want


def test_push_256_and_flush_equal_jax(main_case):
    x, _, ref = main_case
    rx = port_rx()
    assert_same(detected(push_pieces(rx, x, jax_arrays=False)), ref["push"])
    assert rx.flush() is None


def test_superstep_equals_step(main_case):
    """Supersteps of 3 chunks (the carry continuing across the two calls)
    give the per-chunk results, stacked [N, B, K, ...]."""
    x, _, ref = main_case
    rx = port_rx()
    stacked = [rx.superstep(x[:, :3 * CHUNK]),  # [B, N*L] numpy, then [B, N, L] torch
               rx.superstep(torch.from_numpy(x[:, 3 * CHUNK :].reshape(3, 3, CHUNK)))]
    assert stacked[0].mask.shape[:2] == (3, 3) and stacked[0].payload.dim() == 4
    per_chunk = split_results(stacked[0], 3) + split_results(stacked[1], 3)
    steps = port_rx().run(x)
    got = detected(per_chunk)
    assert got.keys() == detected(steps).keys()
    for a, b in zip(per_chunk, steps):
        for name in EXACT + ("start", "evm", "rssi", "cfo", "symbols"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert_same(got, ref["run"])
    assert_same(detected(port_rx().run(x, chunks_per_launch=4)), ref["run"])


def test_carry_continues_across_launches(main_case):
    """Row 2's frame across the boundary between two supersteps is decoded
    once, in the second launch's first chunk."""
    x, sent, _ = main_case
    rx = port_rx()
    r1, r2 = rx.superstep(x[:, :3 * CHUNK]), rx.superstep(x[:, 3 * CHUNK :])
    s = 3 * CHUNK - rx.frame_samples // 2
    hits = [(n, i) for n, r in enumerate((r1, r2)) for i in range(3)
            if bool((r.payload_valid[i, 2] & ((r.start[i, 2] - s).abs() <= 1)).any())]
    assert hits == [(1, 0)]


def test_epoch_split_equals_jax(main_case):
    """With the position preset just below 2^30 the stream crosses an epoch:
    the same (epoch, start) come out of both packages, and a superstep that
    starts before the crossing keeps one epoch for the whole call."""
    x, _, ref = main_case
    rx = port_rx()
    rx._samples_consumed = EPOCH_PRESET
    results = rx.run(x)
    assert [r.epoch for r in results] == [0, 0, 0, 0, 1 << 30, 1 << 30]
    got = detected(results)
    assert_same(got, ref["epoch"])
    assert any(k[2] >= 1 << 30 for k in got) and any(k[2] < 1 << 30 for k in got)
    rx = port_rx()
    rx._samples_consumed = EPOCH_PRESET
    launch = rx.superstep(x)
    assert launch.epoch == 0 and int(launch.start.max()) > (1 << 30) - CHUNK
    assert detected(split_results(launch, N_CHUNKS)).keys() == got.keys()


@pytest.fixture(scope="module")
def bursty_case():
    x, placed = bursty_stream()
    jrx = JStreamingRx(JFrameConfig(*CFG), batch=1, chunk_len=8192)
    ref = jrx.run_adaptive(x, chunks_per_launch=2, k_buckets=(2, 4, 8))
    return x, placed, detected(ref), set(jrx._adaptive_progs), jrx._adaptive_k


def test_run_adaptive_redoes_bursts_and_equals_jax(bursty_case):
    x, placed, ref, j_buckets, j_k = bursty_case
    rx = port_rx(8192, batch=1)
    got = rx.run_adaptive(x, chunks_per_launch=2, k_buckets=(2, 4, 8))
    # the burst group overflowed the first bucket and was decoded again
    assert rx.adaptive_redos >= 1
    assert rx.adaptive_buckets == j_buckets and rx._adaptive_k == j_k
    assert_same(detected(got), ref)
    frames = valid_frames(got)
    assert frames == valid_frames(port_rx(8192, batch=1).run(x))
    assert len(frames) == len(placed)
    for s, payload in placed:
        assert frames[min(frames, key=lambda g: abs(g - s))] == payload


def test_run_adaptive_without_split_stacks_groups(bursty_case):
    x, _, ref, _, _ = bursty_case
    rx = port_rx(8192, batch=1)
    groups = rx.run_adaptive(x, chunks_per_launch=2, k_buckets=(2, 4, 8), split=False)
    assert len(groups) == 3 and all(g.mask.shape[0] == 2 for g in groups)
    per_chunk = [r for g in groups for r in split_results(g, 2)]
    assert_same(detected(per_chunk), ref)


@pytest.fixture(scope="module")
def sparse_case():
    x, n = sparse_stream()
    jrx = JStreamingRx(JFrameConfig(*CFG), batch=1, chunk_len=4096)
    ref = jrx.run_adaptive(x, chunks_per_launch=2)
    return x, n, detected(ref), set(jrx._adaptive_progs), jrx._adaptive_k


def test_run_adaptive_settles_small_on_a_sparse_stream(sparse_case):
    x, n, ref, j_buckets, j_k = sparse_case
    rx = port_rx(4096, batch=1)
    got = rx.run_adaptive(x, chunks_per_launch=2)
    assert_same(detected(got), ref)
    assert sum(int(r.payload_valid.sum()) for r in got) == n
    assert rx.adaptive_buckets <= {2, 3, 4, 6} and rx.adaptive_buckets == j_buckets
    assert rx._adaptive_k == j_k and rx.adaptive_redos == 0
    assert rx.max_frames > max(rx.adaptive_buckets)
    # the settled bucket persists across reset, as in the JAX package
    rx.reset()
    assert rx._adaptive_k == j_k and rx._samples_consumed == 0 and not bool(rx._carry.any())


def test_constructor_and_input_checks():
    with pytest.raises(ValueError, match="overlap"):
        port_rx(1000)
    rx = port_rx()
    assert rx.max_frames == (CHUNK + rx.overlap) // rx.frame_samples + 1
    assert K_BUCKETS[0] == 2 and rx._buf.shape == (3, rx.overlap + CHUNK)
    with pytest.raises(ValueError, match="expected shape"):
        rx.step(np.zeros((3, CHUNK - 1), np.complex64))
    with pytest.raises(ValueError, match="whole number"):
        rx.superstep(np.zeros((3, CHUNK + 1), np.complex64))
    with pytest.raises(AssertionError, match="epoch"):
        rx.superstep(torch.zeros((3, (1 << 30) // CHUNK, 1), dtype=torch.complex64).expand(
            3, (1 << 30) // CHUNK, CHUNK))
