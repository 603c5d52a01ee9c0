"""The time-sharded receiver of the PyTorch port across processes, on the CPU.

Counterpart of ``tests/test_distributed_init.py`` (``WORKER_SHARDED_RX``)
and ``tests/test_distributed_stream.py``: gloo processes spawned with a TCP
rendezvous on a free localhost port (``apps/sharded_rx_demo.spawn_ranks``,
every group under a timeout; a rank that fails fails the test), two of them
on a ``(2, 1)`` grid of ranks and four on ``(2, 2)``. The stream is the
layout of ``WORKER_SHARDED_RX`` on two channels: QPSK at payload 32, 8 time
shards of 2048 samples, a frame inside the first shard and one across every
shard boundary (the boundary between the processes included), 25 dB. The
workers import torch and the port only; the references run here, once: the
one-process port ``sharded_framesync`` (slot by slot: integers, masks and
bytes exact, the statistics to the tolerances of
``tests/test_torch_sharded.py``) and the JAX ``sharded_framesync`` (by
start)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liquiddsp_tpu.core.config import FrameConfig as JFrameConfig
from liquiddsp_tpu.parallel import halo as jhalo
from liquiddsp_tpu.parallel import mesh as jmesh
from liquiddsp_tpu.phy import framegen as jframegen
from liquiddsp_tpu_torch import FrameConfig
from liquiddsp_tpu_torch.apps import sharded_rx_demo as demo
from liquiddsp_tpu_torch.kernels import _cuda
from liquiddsp_tpu_torch.kernels.halo import halo_windows_dist_ref, halo_windows_ref
from liquiddsp_tpu_torch.parallel import mesh as tmesh
from liquiddsp_tpu_torch.parallel.halo import gather_results, sharded_framesync
from liquiddsp_tpu_torch.phy.frame_spec import FrameSpec
from liquiddsp_tpu_torch.runtime.distributed_stream import ShardedStreamingRx
from liquiddsp_tpu_torch.utils.metrics import LinkMetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = (1, 0, 0, 32)
N_TIME, T_LOCAL, K, ROWS = 8, 2048, 4, 2
STREAM_CFG, CHUNK = (1, 0, 0, 64), 16384
SPAWN_TIMEOUT_S = 240.0


def boundary_stream():
    """(x [2, 8 * 2048] complex64, starts [2, 8], payloads [2, 8, 32]):
    WORKER_SHARDED_RX's layout, a row of its own frames and noise a channel."""
    rng = np.random.default_rng(0)
    payloads = rng.integers(0, 256, (ROWS, 8, 32), dtype=np.uint8)
    frames = np.asarray(jframegen.framegen(jnp.asarray(payloads.reshape(-1, 32)), JFrameConfig(*CFG)))
    frames = frames.reshape(ROWS, 8, -1)
    f = frames.shape[-1]
    starts = np.array([[300] + [T_LOCAL * (i + 1) - f // 2 for i in range(7)]] * ROWS)
    x = np.zeros((ROWS, N_TIME * T_LOCAL), np.complex64)
    for b in range(ROWS):
        for s, fr in zip(starts[b], frames[b]):
            x[b, s : s + f] = fr
    sigma = np.sqrt(float(np.mean(np.abs(frames) ** 2)) / (2 * 10 ** (25.0 / 10)))
    x += (sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    return x, starts, payloads


def stream_layout():
    """tests/test_distributed_stream.py's five placements (mid-shard, a shard
    boundary, two super-block boundaries, inside block 3) in three chunks."""
    rng = np.random.default_rng(0)
    payloads = rng.integers(0, 256, (5, 64), dtype=np.uint8)
    frames = np.asarray(jframegen.framegen(jnp.asarray(payloads), JFrameConfig(*STREAM_CFG)))
    f = frames.shape[1]
    shard_len = (CHUNK + f - 1 + ((-(CHUNK + f - 1)) % 8)) // 8
    starts = [1000, shard_len * 3 - f // 2, CHUNK - f // 2, 2 * CHUNK - f + 37, 2 * CHUNK + 5000]
    x = np.zeros((1, 3 * CHUNK), np.complex64)
    for s, fr in zip(starts, frames):
        x[0, s : s + f] += fr
    order = np.argsort(starts)
    return x, np.array(starts)[order][None], payloads[order][None]


@pytest.fixture(scope="module")
def refs():
    """The stream and its one-process references, computed once here."""
    x, starts, payloads = boundary_stream()
    port = sharded_framesync(torch.from_numpy(x), FrameConfig(*CFG),
                             tmesh.make_mesh(N_TIME, ROWS, devices=["cpu"]), max_frames_per_shard=K)
    jm = jmesh.make_mesh(n_time=N_TIME, n_ch=1, devices=jax.devices()[:N_TIME])
    jres = jax.jit(lambda a: jhalo.sharded_framesync(a, JFrameConfig(*CFG), jm, max_frames_per_shard=K))(
        jhalo.shard_stream(jnp.asarray(x), jm))
    sx, sstarts, spayloads = stream_layout()
    rx = ShardedStreamingRx(FrameConfig(*STREAM_CFG), tmesh.make_mesh(N_TIME, 1, devices=["cpu"]),
                            batch=1, chunk_len=CHUNK, max_frames_per_shard=K)
    steps = [rx.step(torch.from_numpy(sx[:, p : p + CHUNK])) for p in range(0, sx.shape[1], CHUNK)]
    return {"x": x, "truth": (starts, payloads), "port": port, "jax": jres,
            "stream": (sx, sstarts, spayloads), "stream_steps": steps}


GRIDS = {2: (2, 1), 4: (2, 2)}


@pytest.fixture(scope="module")
def runs(refs):
    """Rank 0's results of a group of 2 (the boundary stream, then three
    chunks of the streaming layout) and of a group of 4 (the boundary
    stream)."""
    boundary = demo.Job("boundary", CFG, refs["x"], N_TIME, ROWS, k=K, truth=refs["truth"])
    stream = demo.Job("stream", STREAM_CFG, refs["stream"][0], N_TIME, 1, k=K, chunk=CHUNK)
    return {
        2: demo.spawn_ranks(2, [boundary, stream], "cpu", ranks=GRIDS[2], timeout_s=SPAWN_TIMEOUT_S),
        4: demo.spawn_ranks(4, [boundary], "cpu", ranks=GRIDS[4], timeout_s=SPAWN_TIMEOUT_S),
    }


WORLDS = pytest.mark.parametrize("world", [2, 4], ids=["2 ranks (2,1)", "4 ranks (2,2)"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here, as in the ranks: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the mesh over ranks --------------------------------------------------------


def test_init_distributed_for_one_process_is_a_noop():
    assert tmesh.init_distributed(world_size=1) is None
    assert tmesh.init_distributed() is None  # no WORLD_SIZE in the environment
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("rank", range(4))
def test_mesh_places_ranks_time_major(rank):
    """rank = pt * P_c + pc, as the JAX mesh reshapes its devices; left and
    right in the same ch column; local_block cuts rows and columns."""
    m = tmesh.Mesh(n_time=8, n_ch=2, device=torch.device("cpu"), ranks=(2, 2), rank=rank)
    pt, pc = divmod(rank, 2)
    assert m.coords == (pt, pc) and m.world == 4 and m.local_time == 4
    assert list(m.time_shards) == list(range(4 * pt, 4 * pt + 4))
    assert (m.left, m.right) == ((None, rank + 2) if pt == 0 else (rank - 2, None))
    assert m.holds_last_time == (pt == 1)
    x = torch.arange(4 * 16, dtype=torch.float32).reshape(4, 16).to(torch.complex64)
    assert tmesh.local_block(x, m).equal(x[2 * pc : 2 * pc + 2, 8 * pt : 8 * pt + 8])
    assert m.ch_rows(4) == slice(2 * pc, 2 * pc + 2)


def test_make_mesh_refuses_a_grid_without_a_process_group():
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_mesh(8, 2, devices=["cpu"], ranks=(2, 1))
    assert tmesh.make_mesh(8, 2, devices=["cpu"], ranks=(1, 1)).world == 1


def test_one_process_helpers_leave_the_mesh_alone(refs):
    """psum and gather_results of a one-process mesh return what they are given."""
    m = tmesh.make_mesh(N_TIME, ROWS, devices=["cpu"])
    met = LinkMetrics.from_results(refs["port"], N_TIME * T_LOCAL)
    assert met.psum(m) is met
    got = gather_results(refs["port"], m)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(refs["port"], f.name)
        assert a.equal(b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.parametrize("has_right", [False, True])
def test_halo_windows_dist_ref_is_the_plain_windows_with_the_right_head(has_right):
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((2, 3 * 64)) + 1j * rng.standard_normal((2, 3 * 64)))
                         .astype(np.complex64))
    head = torch.from_numpy(rng.standard_normal((2, 10)).astype(np.complex64)) if has_right else None
    got = halo_windows_dist_ref(x, 3, 10, head)
    ref = halo_windows_ref(x, 3, 10)
    assert got[:, :, :64].equal(ref[:, :, :64]) and got[:2].equal(ref[:2])
    assert got[2, :, 64:].equal(head if has_right else torch.zeros((2, 10), dtype=torch.complex64))


# -- across processes -----------------------------------------------------------


@WORLDS
def test_every_rank_windows_equal_the_plain_windows(runs, world):
    """Each rank's windows, its last tail received from the right rank by
    the send and receive of the plain version, equal halo_windows_ref of the
    whole stream's shards, exactly (checked in every rank)."""
    out = runs[world][0]
    ov = FrameSpec(FrameConfig(*CFG)).frame_samples - 1
    p_t, p_c = GRIDS[world]
    assert out["windows_exact"] == [True] * world
    assert out["windows_shape"] == (N_TIME // p_t, ROWS // p_c, T_LOCAL + ov)


@pytest.mark.parametrize(
    "field", ["mask", "header_valid", "payload_valid", "start", "modulation", "inner_code",
              "outer_code", "payload_len", "header_user", "payload"])
@WORLDS
def test_gathered_discrete_fields_equal_one_process_slot_by_slot(runs, world, refs, field):
    """Exact, as in tests/test_torch_sharded.py: ``mask``, validity and
    ``start`` on every slot (so global shard i's K slots sit at columns
    i*K .. (i+1)*K - 1 in both), the decoded fields on the slots that hold a
    detection (the others decode noise)."""
    outs = runs[world]
    got, want = getattr(outs[0]["res"], field), getattr(refs["port"], field)
    assert got.dtype == want.dtype and got.shape == want.shape
    if field in ("mask", "header_valid", "payload_valid", "start"):
        assert got.equal(want)
    else:
        m = refs["port"].mask
        assert got[m].equal(want[m])


@pytest.mark.parametrize("field,atol", [("evm", 0.02), ("rssi", 1e-3), ("cfo", 1e-6)])
@WORLDS
def test_gathered_stats_close_to_one_process(runs, world, refs, field, atol):
    outs = runs[world]
    m = refs["port"].mask
    np.testing.assert_allclose(getattr(outs[0]["res"], field)[m].numpy(),
                               getattr(refs["port"], field)[m].numpy(), atol=atol)
    sym, ref = outs[0]["res"].symbols[m], refs["port"].symbols[m]
    np.testing.assert_allclose(sym.numpy(), ref.numpy(), atol=2e-3 * float(ref.abs().max()))


@WORLDS
def test_every_frame_found_once_across_the_process_boundary(runs, world):
    """16 frames, 14 across a shard boundary, 2 across the boundary between
    time ranks; every one exactly once and bit-exact (counted in rank 0)."""
    outs = runs[world]
    assert outs[0]["found"] == 16
    assert int(outs[0]["res"].payload_valid.sum()) == 16


@WORLDS
def test_gathered_equal_jax_by_start(runs, world, refs):
    """The JAX sharded receiver over 8 CPU devices on the same samples: the
    same frames at the same starts with the same bytes, row by row."""
    outs = runs[world]
    j = refs["jax"]
    for b in range(ROWS):
        def frames(mask, start, payload):
            return sorted((int(s), bytes(p)) for s, p, m in zip(start, payload, mask) if m)
        got = frames(outs[0]["res"].payload_valid[b].numpy(), outs[0]["res"].start[b].numpy(),
                     outs[0]["res"].payload[b].numpy())
        want = frames(np.asarray(j.payload_valid)[b], np.asarray(j.start)[b], np.asarray(j.payload)[b])
        assert got == want and len(got) == 8


@WORLDS
def test_psum_metrics_equal_one_process(runs, world, refs):
    """Counts exact, int32; the dB sums float32 within 1e-5 relative (sums
    of 16 values in another order)."""
    outs = runs[world]
    want = LinkMetrics.from_results(refs["port"], N_TIME * T_LOCAL)
    got = outs[0]["metrics"]
    for name in ("samples", "frames_detected", "headers_valid", "payloads_valid"):
        assert got[name] == int(getattr(want, name)) and getattr(want, name).dtype == torch.int32
    assert (got["frames_detected"], got["payloads_valid"]) == (16, 16)
    for name in ("sum_evm_db", "sum_rssi_db"):
        np.testing.assert_allclose(got[name], float(getattr(want, name)), rtol=1e-5, atol=1e-6)


@WORLDS
def test_no_kernel_launched_on_the_cpu(runs, world):
    outs = runs[world]
    assert all(set(c.values()) == {0} for c in outs[0]["launches"])


def test_streaming_over_two_ranks_finds_every_frame_once(runs, refs):
    """Three chunks of ShardedStreamingRx over 2 ranks: the five frames of
    test_distributed_stream.py, each exactly once, equal to the one-process
    run step by step (slots exact, counts exact, dB sums to 1e-5)."""
    steps = runs[2][1]["steps"]
    found = 0
    _, starts, payloads = refs["stream"]
    for st, (res, m) in zip(steps, refs["stream_steps"]):
        for name in ("mask", "start", "payload_valid"):
            assert getattr(st["res"], name).equal(getattr(res, name)), name
        assert st["res"].payload[res.mask].equal(res.payload[res.mask])
        assert st["res"].epoch == res.epoch
        for f in dataclasses.fields(m):
            np.testing.assert_allclose(st["metrics"][f.name], getattr(m, f.name).item(), rtol=1e-5)
        assert st["metrics"]["samples"] == 17440
        found += demo.frames_once(st["res"], starts, payloads)
    assert found == 5 and len(steps) == 3
    assert [st["metrics"]["frames_detected"] for st in steps] == [2, 1, 2]


# -- two ranks building the kernels at once on a fresh tree ---------------------

FAKE_NVCC = r"""#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open(os.environ["NVCC_LOG"], "a") as fh:
    fh.write(out + "\n")
if "-c" in args:
    src = args[args.index("-c") + 1]
    time.sleep(0.3)  # long enough for the two builds to overlap
    with open(out, "w") as fh:
        fh.write(open(src).read())
else:  # -shared: the objects, in order, make the library
    with open(out, "w") as fh:
        fh.write("".join(open(a).read() for a in args if a.endswith(".o")))
print("ptxas info    : Used 1 registers, 0 bytes spill stores, 0 bytes spill loads")
"""

BUILD_ONE = """
import sys
from pathlib import Path
from liquiddsp_tpu_torch.kernels import _cuda
_cuda.CSRC, _cuda.BUILD_DIR = Path(sys.argv[1]), Path(sys.argv[2])
_cuda.toolkit_exe = lambda name: sys.argv[3]
print(_cuda.build())
"""


def test_two_processes_building_at_once_each_load_a_whole_library(tmp_path):
    """Each build compiles into an object directory of its own (no shared
    object path), and the library and its log appear whole under their final
    names; no object directory is left behind. ``nvcc`` is a stub that copies
    sources to objects and concatenates objects into the library."""
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    for name in _cuda.SOURCES:
        (csrc / name).write_text(f"<{name}>")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.replace("{python}", sys.executable))
    nvcc.chmod(0o755)
    env = {**os.environ, "NVCC_LOG": str(tmp_path / "nvcc.log"), "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE, str(csrc), str(build), str(nvcc)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lib = {o.strip() for o, _ in outs}
    assert len(lib) == 1
    lib = lib.pop()
    assert open(lib).read() == "".join(f"<{n}>" for n in _cuda.SOURCES)
    assert sorted(p.name for p in build.iterdir()) == sorted([os.path.basename(lib),
                                                               os.path.basename(lib)[:-3] + ".log"])
    written = open(tmp_path / "nvcc.log").read().split()
    objs = [w for w in written if w.endswith(".o")]
    assert len(objs) == 2 * len(_cuda.SOURCES) == len(set(objs))  # no object path shared
    assert len({os.path.dirname(o) for o in objs}) == 2
