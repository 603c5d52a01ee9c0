"""The benchmark's transmitter against the program's, and the cyclic stream."""

import dataclasses

import numpy as np
import pytest
import torch

from rxbench import frame as fr
from rxbench import tx

CONFIGS = ("qpsk_v27_golay24", "qpsk_uncoded")
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_frames_equal_the_programs(name):
    from liquiddsp_tpu_torch.core.config import FrameConfig
    from liquiddsp_tpu_torch.phy import framegen

    cfg = fr.load_config(name)
    gen = torch.Generator().manual_seed(3)
    pay = torch.randint(0, 256, (5, cfg.payload_len), generator=gen).to(torch.uint8)
    user = torch.randint(0, 256, (5, 14), generator=gen).to(torch.uint8)
    pc = FrameConfig(cfg.modulation, cfg.inner_code, cfg.outer_code, cfg.payload_len)
    tables = framegen.phy_tables(pc, CPU)
    want_syms = framegen.assemble_symbols(pay, pc, user, tables)
    got_syms = torch.cat([tx.const(tx.preamble_symbols(), CPU).expand(5, -1),
                          tx.header_symbols(tx.header_bytes(cfg, user)),
                          tx.payload_symbols(cfg, pay)], dim=-1)
    assert torch.equal(got_syms, want_syms)
    got = tx.framegen(cfg, pay, user)
    want = framegen.framegen(pay, pc, user_header=user, device=CPU)
    assert got.shape == (5, cfg.frame_samples) == want.shape
    assert float((got - want).abs().max()) < 1e-6


def test_geometry():
    coded, uncoded = fr.load_config("qpsk_v27_golay24"), fr.load_config("qpsk_uncoded")
    assert (coded.frame_samples, coded.period, coded.outer_bits + fr.V27_TAIL) == (2688, 4875, 1086)
    assert (uncoded.frame_samples, uncoded.period) == (1052, 1930)
    assert fr.slots_for(coded, 65536) == 15 and fr.slots_for(uncoded, 65536) == 36
    perm = fr.interleave_perm(coded.inner_bits)
    assert sorted(perm.tolist()) == list(range(coded.inner_bits))


def _clean(name):
    return dataclasses.replace(fr.load_config(name), snr_db=float("inf"))


@pytest.mark.parametrize("name", CONFIGS)
def test_pool_is_a_continuous_circle(name):
    """Without noise, every frame of the circle is its transmitted frame
    under its carrier, also across the wrap, and nothing else is there."""
    cfg = _clean(name)
    batch, chunk_len, n = 3, 8192, 3
    pool = tx.make_pool(cfg, batch, chunk_len, n, 2**31 + 99, CPU)
    x = pool.chunks.transpose(0, 1).reshape(batch, -1)  # the circle, channel by channel
    circle = n * chunk_len
    f = cfg.frame_samples
    frames = tx.framegen(cfg, torch.from_numpy(pool.payload.reshape(-1, cfg.payload_len)),
                         torch.from_numpy(pool.user.reshape(-1, 14))).reshape(batch, -1, f)
    covered = torch.zeros(x.shape, dtype=torch.bool)
    wraps = 0
    for b in range(batch):
        for j, s in enumerate(pool.layout.starts[b]):
            idx = (int(s) + np.arange(f)) % circle
            wraps += int(idx[-1] < idx[0])
            t = np.arange(f) + int(s)
            rot = np.exp(1j * (pool.phase[b] + pool.cfo[b] * t))
            want = frames[b, j].numpy() * rot
            assert np.abs(x[b, idx].numpy() - want).max() < 1e-5
            covered[b, idx] = True
    assert float(x[~covered].abs().max()) == 0.0
    assert np.all(np.abs(pool.cfo) <= cfg.cfo_max)


def test_seed_fixes_the_stream():
    cfg = fr.load_config("qpsk_uncoded")
    a = tx.make_pool(cfg, 2, 4096, 2, 3_000_000_007, CPU)
    b = tx.make_pool(cfg, 2, 4096, 2, 3_000_000_007, CPU)
    c = tx.make_pool(cfg, 2, 4096, 2, 3_000_000_008, CPU)
    assert torch.equal(a.chunks, b.chunks) and np.array_equal(a.payload, b.payload)
    assert not torch.equal(a.chunks, c.chunks)


def test_crc24_matches_the_programs():
    from liquiddsp_tpu_torch.ops import crc

    m = torch.randint(0, 256, (7, 67), generator=torch.Generator().manual_seed(1)).to(torch.uint8)
    assert torch.equal(tx.crc24(m), crc.crc24(m).to(torch.int64))
