"""The index arithmetic of the Viterbi and recover CUDA kernels, on the CPU.

A CUDA kernel cannot run without a card, but what the two kernels decide in
index arithmetic is written as pure functions in ``kernels/viterbi.py`` and
``kernels/recover.py``. Here a numpy emulation of the Viterbi kernel's warp
schedule (32 lanes x 2 metric registers, one lane exchange a step, the
maximum through the ordered-integer map, the traceback on the rotated lane
index in blocks of 30 steps) is held bit for bit against ``viterbi_ref``, and
a float32 emulation of the recover kernel's 4-sample phasor recurrence against
``recover_symbols_planes_ref`` within the kernel's tolerance.
"""

import numpy as np
import pytest
import torch

from liquiddsp_tpu_torch.kernels import recover as trecover
from liquiddsp_tpu_torch.kernels import viterbi as tv
from liquiddsp_tpu_torch.ops.fec import conv

F32 = np.float32
LANE = np.arange(tv.LANES)


# -- the rotating layout ------------------------------------------------------


@pytest.mark.parametrize("phase", range(tv.PHASES))
def test_layout_is_a_bijection_of_predecessor_pairs(phase):
    states = np.stack([tv.warp_state(LANE, 0, phase), tv.warp_state(LANE, 1, phase)], axis=1)
    assert sorted(states.reshape(-1)) == list(range(64))
    np.testing.assert_array_equal(states[:, 1], states[:, 0] + 32)  # a pair (p, p + 32)
    lane, slot = tv.warp_lane_slot(states, phase)
    np.testing.assert_array_equal(lane, np.stack([LANE, LANE], axis=1))
    np.testing.assert_array_equal(slot, np.stack([0 * LANE, 0 * LANE + 1], axis=1))


@pytest.mark.parametrize("phase", range(2 * tv.PHASES))
def test_one_exchange_leads_to_the_next_phase(phase):
    """A lane computes 2q and 2q + 1, keeps one and swaps the other with the
    lane at ``exchange_mask``: what it then holds is the next phase's pair."""
    q = tv.warp_state(LANE, 0, phase)
    even, odd = (2 * q) % 64, (2 * q + 1) % 64
    # the predecessors of both new states are the lane's own pair
    for new in (even, odd):
        np.testing.assert_array_equal(new >> 1, q)
    mask = tv.exchange_mask(phase)
    assert mask == 1 << ((4 - phase) % 5)
    hi = (LANE & mask) != 0
    send = np.where(hi, even, odd)
    recv = send[LANE ^ mask]
    slot0, slot1 = np.where(hi, recv, even), np.where(hi, odd, recv)
    np.testing.assert_array_equal(slot0, tv.warp_state(LANE, 0, phase + 1))
    np.testing.assert_array_equal(slot1, tv.warp_state(LANE, 1, phase + 1))


@pytest.mark.parametrize("phase", range(tv.PHASES))
def test_decision_bit_and_traceback_step(phase):
    """The ballots of a step put new state s at (word s & 1, bit = the lane
    that computed it); stepping back replaces one bit of that lane index."""
    q = tv.warp_state(LANE, 0, phase)
    for parity in (0, 1):
        word, bit = tv.decision_bit((2 * q + parity) % 64, phase)
        np.testing.assert_array_equal(word, parity)
        np.testing.assert_array_equal(bit, LANE)
    pos = tv.traceback_pos(phase)
    for s in range(64):
        word, lane = tv.decision_bit(s, phase)
        for d in (0, 1):
            prev = (s >> 1) | (d << 5)
            pword, plane = tv.decision_bit(prev, phase - 1)
            assert pword == (lane >> pos) & 1
            assert plane == (lane & ~(1 << pos)) | (d << pos)


def test_warp_signs_follow_the_layout():
    e = conv.branch_signs()
    ws = tv.warp_signs()
    assert ws.shape == (tv.PHASES, tv.LANES, 8) and ws.dtype == np.float32
    assert set(np.unique(ws)) == {-1.0, 1.0}
    for k in range(tv.PHASES):
        for lane in range(tv.LANES):
            q = tv.warp_state(lane, 0, k)
            np.testing.assert_array_equal(ws[k, lane, :4], e[2 * q])
            np.testing.assert_array_equal(ws[k, lane, 4:], e[2 * q + 1])


# -- the ordered-integer map ----------------------------------------------------


def test_ordered_map_is_monotone_and_round_trips():
    rng = np.random.default_rng(3)
    tiny = np.float32(1e-45)  # the smallest denormal
    special = np.array(
        [-1e9, -0.0, 0.0, tiny, -tiny, 1e-40, -1e-40, np.finfo(F32).tiny, -np.finfo(F32).tiny,
         np.finfo(F32).max, np.finfo(F32).min, 1.0, -1.0], dtype=F32)
    vals = np.concatenate([
        special,
        rng.standard_normal(4000).astype(F32) * F32(10.0) ** rng.integers(-30, 30, 4000).astype(F32),
        rng.integers(-2**31, 2**31, 4000).astype(np.int32).view(F32),
    ])
    vals = vals[np.isfinite(vals)]
    keys = tv.float_to_ordered(vals.view(np.int32))
    assert keys.dtype == np.int32
    np.testing.assert_array_equal(tv.ordered_to_float(keys), vals.view(np.int32))  # bit patterns
    a, b = vals[:, None], vals[None, :]
    ka, kb = keys[:, None], keys[None, :]
    assert np.all((ka < kb)[a < b]) and np.all((ka > kb)[a > b])
    # equal floats with different keys: only the two zeros, -0.0 below +0.0
    differ = (a == b) & (ka != kb)
    assert np.all(a[differ.nonzero()[0], 0] == 0.0)
    assert tv.float_to_ordered(F32(-0.0).view(np.int32)) == -1
    assert tv.float_to_ordered(F32(0.0).view(np.int32)) == 0
    # the integer maximum is the float maximum
    for row in rng.standard_normal((50, 64)).astype(F32) * F32(1e3):
        key = tv.float_to_ordered(row.view(np.int32)).max()
        assert tv.ordered_to_float(key).view(F32) == row.max()


# -- the warp schedule against the reference -----------------------------------


def _ballot(pred):
    """[B, 32] bool -> [B] uint32, lane l at bit l."""
    return (pred.astype(np.uint64) << LANE.astype(np.uint64)).sum(axis=1).astype(np.uint32)


def emulate_warp_viterbi(lam: np.ndarray) -> np.ndarray:
    """What one warp a frame computes in ``csrc/viterbi.cu``: lam [B, steps, 2]
    float32 -> bits [B, steps] int8. Every float operation is a float32 numpy
    operation in the kernel's order."""
    b, steps, _ = lam.shape
    signs = tv.warp_signs()
    n_pad = -(-steps // tv.PHASES) * tv.PHASES  # steps beyond the end see lam = 0
    lam = np.concatenate([lam, np.zeros((b, n_pad - steps, 2), F32)], axis=1)
    m_a = np.tile(np.where(LANE == 0, F32(0.0), F32(-1e9)).astype(F32), (b, 1))
    m_b = np.full((b, tv.LANES), -1e9, F32)
    mx = np.zeros((b, 1), F32)
    words = np.zeros((b, n_pad, 2), np.uint32)
    for t in range(n_pad):
        k = t % tv.PHASES
        e = signs[k]
        l0, l1 = lam[:, t, 0:1], lam[:, t, 1:2]
        n_a, n_b = m_a - mx, m_b - mx
        ce0 = (n_a + l0 * e[:, 0]) + l1 * e[:, 1]
        ce1 = (n_b + l0 * e[:, 2]) + l1 * e[:, 3]
        co0 = (n_a + l0 * e[:, 4]) + l1 * e[:, 5]
        co1 = (n_b + l0 * e[:, 6]) + l1 * e[:, 7]
        assert ce0.dtype == F32
        words[:, t, 0] = _ballot(ce1 > ce0)
        words[:, t, 1] = _ballot(co1 > co0)
        me, mo = np.maximum(ce0, ce1), np.maximum(co0, co1)
        key = tv.float_to_ordered(np.maximum(me, mo).view(np.int32)).max(axis=1, keepdims=True)
        mx = tv.ordered_to_float(key).view(F32)
        mask = tv.exchange_mask(k)
        hi = (LANE & mask) != 0
        recv = np.where(hi, me, mo)[:, LANE ^ mask]
        m_a, m_b = np.where(hi, recv, me), np.where(hi, mo, recv)

    bits = np.zeros((b, steps), np.int8)
    lane_idx = np.zeros(b, np.uint32)
    bit = np.zeros(b, np.uint32)
    tb = tv.TRACEBACK_BLOCK
    for t in range(-(-steps // tb) * tb - 1, -1, -1):
        w = words[:, t] if t < steps else np.zeros((b, 2), np.uint32)  # beyond the end: no decision
        word = np.where(bit == 1, w[:, 1], w[:, 0])
        if t < steps:
            bits[:, t] = bit
        pos = tv.traceback_pos((t % tb) % tv.PHASES)
        d = (word >> lane_idx) & 1
        bit = (lane_idx >> pos) & 1
        lane_idx = (lane_idx & ~np.uint32(1 << pos)) | (d << pos)
    return bits


def _lam(kind: str, steps: int, seed: int, batch: int = 6) -> np.ndarray:
    rng = np.random.default_rng(seed)
    nbits = steps - conv.NTAIL
    msg = rng.integers(0, 2, (batch, nbits)).astype(np.int8)
    coded = conv.encode(torch.from_numpy(msg), 1).numpy().astype(F32)
    lam = (1.0 - 2.0 * coded).astype(F32)
    if kind == "noisy":
        lam += (0.9 * rng.standard_normal(lam.shape)).astype(F32)
    elif kind == "erasures":
        lam[:] = 0.0  # every add-compare-select ties
    elif kind == "mixed":
        lam[:, ::3] = 0.0  # erasures among hard decisions: ties at many steps
        lam[: batch // 2, 1::7] *= -1.0
    return lam.reshape(batch, steps, 2)


@pytest.mark.parametrize("steps", [7, 37, 193, 1086])
@pytest.mark.parametrize("kind", ["noisy", "erasures", "mixed", "hard"])
def test_warp_schedule_is_bit_exact(kind, steps):
    lam = _lam(kind, steps, seed=steps)
    ref = tv.viterbi_ref(torch.from_numpy(lam)).numpy()
    got = emulate_warp_viterbi(lam)
    np.testing.assert_array_equal(got, ref)


def test_viterbi_wrapper_pads_decisions_to_whole_periods():
    """The scratch row of decision words is a whole number of 5-step periods
    and of no other use on the CPU, where the wrapper takes the plain version."""
    lam = torch.from_numpy(_lam("noisy", 37, seed=1))
    np.testing.assert_array_equal(tv.viterbi(lam).numpy(), tv.viterbi_ref(lam).numpy())
    assert tv.TRACEBACK_BLOCK % tv.PHASES == 0 and tv.TRACEBACK_BLOCK <= tv.LANES


# -- recover: tile, alignment, phasor recurrence --------------------------------


@pytest.mark.parametrize("n_syms", [1, 2, 3, 4, 5, 443, 444, 445, 511, 512, 513, 600, 1024, 1025,
                                    1330, 1331, 2199, 4426])
def test_recover_tile(n_syms):
    tile, blocks = trecover.recover_tile(n_syms)
    assert tile % trecover.SYMS_PER_THREAD == 0 and 0 < tile <= trecover.MAX_TILE
    assert (blocks - 1) * tile < n_syms <= blocks * tile  # covered, no empty block
    assert blocks == -(-n_syms // trecover.MAX_TILE)  # no more blocks than the largest tile needs
    last = n_syms - (blocks - 1) * tile
    assert tile - last < trecover.SYMS_PER_THREAD * blocks  # the last block is as full as the others
    assert (2 * tile) % 8 == 0  # a tile starts on a multiple of 8 samples


def test_recover_tile_main_path_shapes():
    assert trecover.recover_tile(512) == (512, 1)
    assert trecover.recover_tile(1330) == (444, 3)
    with pytest.raises(ValueError):
        trecover.recover_tile(0)


def test_load_width_follows_the_rows_phase():
    assert [trecover.load_width(a) for a in (0, 4, 8, 12, 16, 24, 36)] == [16, 4, 8, 4, 16, 8, 4]
    base = 1 << 20
    for n_syms, widths in ((512, {16}), (1330, {16}), (513, {16, 8}), (1, {16, 8})):
        n = 2 * n_syms + 28
        assert {trecover.load_width(base + 4 * c * n) for c in range(8)} == widths
    assert {trecover.load_width(base + 4 * c * 1055) for c in range(8)} == {16, 8, 4}


def emulate_recover(wr, wi, dphi, phi, gamma, taps, n_syms):
    """The arithmetic of ``csrc/recover.cu`` in float32 numpy: a full-range
    sin/cos of the fused ``dphi * m + phi`` at every fourth sample, three
    phasor steps by (cos dphi, sin dphi) between, then the 30 multiply-adds in
    ascending tap order. Tiles start on multiples of 8 samples, so the
    quads are those of the whole row."""
    c, n = wr.shape
    n4 = -(-n // 4) * 4
    a = np.zeros((c, n4), F32)
    b = np.zeros((c, n4), F32)
    a[:, :n], b[:, :n] = wr, wi
    m = np.arange(0, n4, 4)
    th = (dphi.astype(np.float64)[:, None] * m + phi.astype(np.float64)[:, None]).astype(F32)
    cs, sn = np.cos(th), np.sin(th)
    cd, sd = np.cos(dphi)[:, None], np.sin(dphi)[:, None]
    assert cs.dtype == F32 and cd.dtype == F32
    ig = (F32(1.0) / np.maximum(gamma, F32(1e-9)))[:, None]
    dr, di = np.zeros_like(a), np.zeros_like(b)
    for u in range(4):
        au, bu = a[:, u::4], b[:, u::4]
        dr[:, u::4] = (au * cs + bu * sn) * ig
        di[:, u::4] = (bu * cs - au * sn) * ig
        cs, sn = cs * cd - sn * sd, sn * cd + cs * sd
    yr = np.zeros((c, n_syms), F32)
    yi = np.zeros((c, n_syms), F32)
    for v in range(trecover.N_TAPS):
        tv_ = taps[:, v, None]
        yr = dr[:, v : v + 2 * n_syms : 2] * tv_ + yr
        yi = di[:, v : v + 2 * n_syms : 2] * tv_ + yi
    assert yr.dtype == F32
    return yr + 1j * yi


@pytest.mark.parametrize("n_syms, dphi_max, phi_max", [
    (512, 0.05, np.pi), (1330, 0.05, np.pi), (1331, 0.05, np.pi), (1, 0.05, np.pi),
    (445, 0.1, np.pi), (2199, 0.056, 4.0),  # n = 4426 samples, |phase| up to 250 rad
])
def test_phasor_recurrence_stays_within_tolerance(n_syms, dphi_max, phi_max):
    rng = np.random.default_rng(n_syms)
    c = 24
    n = 2 * n_syms + 28
    wr = rng.standard_normal((c, n)).astype(F32)
    wi = rng.standard_normal((c, n)).astype(F32)
    dphi = rng.uniform(-dphi_max, dphi_max, c).astype(F32)
    dphi[:2] = (dphi_max, -dphi_max)
    phi = rng.uniform(-phi_max, phi_max, c).astype(F32)
    phi[:2] = (phi_max, -phi_max)
    gamma = rng.uniform(0.5, 2.0, c).astype(F32)
    taps = rng.standard_normal((c, trecover.N_TAPS)).astype(F32) * F32(0.3)
    t = torch.from_numpy
    ref = trecover.recover_symbols_planes_ref(
        t(wr), t(wi), t(dphi), t(phi), t(gamma), t(taps), n_syms).numpy()
    got = emulate_recover(wr, wi, dphi, phi, gamma, taps, n_syms)
    if n_syms == 2199:
        assert np.abs(dphi[0] * (n - 1) + phi[0]) > 250.0
    err = np.abs(got - ref).max()
    assert err <= 2e-4 * np.abs(ref).max(), (err, np.abs(ref).max())
