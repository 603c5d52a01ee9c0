"""Every constant table and the frame geometry of the PyTorch port equal the
JAX package's (numpy only: exact equality, no tolerance)."""

import numpy as np
import pytest

from liquiddsp_tpu.core import config as jcfg
from liquiddsp_tpu.ops import crc as jcrc
from liquiddsp_tpu.ops import modem as jmodem
from liquiddsp_tpu.ops import msequence as jmseq
from liquiddsp_tpu.ops import rrc as jrrc
from liquiddsp_tpu.ops.fec import block as jblock
from liquiddsp_tpu.ops.fec import conv as jconv
from liquiddsp_tpu.ops.fec import registry as jreg
from liquiddsp_tpu.ops.fec import rs as jrs
from liquiddsp_tpu.phy import detector as jdet
from liquiddsp_tpu.phy import frame_spec as jfs
from liquiddsp_tpu.phy import framesync as jsync
from liquiddsp_tpu_torch.core import config as tcfg
from liquiddsp_tpu_torch.ops import crc as tcrc
from liquiddsp_tpu_torch.ops import modem as tmodem
from liquiddsp_tpu_torch.ops.fec import block as tblock
from liquiddsp_tpu_torch.ops.fec import conv as tconv
from liquiddsp_tpu_torch.ops.fec import registry as treg
from liquiddsp_tpu_torch.ops.fec import rs as trs
from liquiddsp_tpu_torch.phy import frame_spec as tfs
from liquiddsp_tpu_torch.phy import tables as ttables

GEOMETRY = (
    "bps", "payload_msg_bytes", "outer_bits", "inner_bits", "payload_syms",
    "payload_pad_bits", "frame_syms", "frame_samples", "header_sym_offset",
    "payload_sym_offset",
)


@pytest.mark.parametrize("payload_len", [32, 64, 256])
@pytest.mark.parametrize("modulation", range(11))
def test_frame_geometry_equal_for_all_configs(modulation, payload_len):
    for inner in range(7):
        for outer in range(8):
            a = jfs.FrameSpec(jcfg.FrameConfig(modulation, inner, outer, payload_len))
            b = tfs.FrameSpec(tcfg.FrameConfig(modulation, inner, outer, payload_len))
            for name in GEOMETRY:
                assert getattr(a, name) == getattr(b, name), (name, inner, outer)


def test_bench_config_geometry():
    """The numbers the block receiver's two configs are sized by."""
    a = tfs.FrameSpec(tcfg.FrameConfig(1, 0, 0, 64))
    b = tfs.FrameSpec(tcfg.FrameConfig(1, 1, 1, 64))
    assert (a.frame_syms, a.frame_samples) == (512, 1052)
    assert (b.frame_syms, b.frame_samples) == (1330, 2688)
    assert b.outer_bits + tconv.NTAIL == 1086


def test_config_enums_and_ids_equal():
    for name in ("MOD_BPS", "MOD_CONSTELLATION_N", "CE_INNER_RATE", "CE_OUTER_RATE",
                 "TRUE_INNER_RATE", "TRUE_OUTER_RATE", "NUM_CONFIGS"):
        assert getattr(jcfg, name) == getattr(tcfg, name)
    for enum in ("Modulation", "InnerCode", "OuterCode"):
        assert {m.name: int(m) for m in getattr(jcfg, enum)} == {
            m.name: int(m) for m in getattr(tcfg, enum)}
    for cid in range(1, 617):
        assert jcfg.config_from_id(cid) == tcfg.config_from_id(cid)
        assert tcfg.config_id(*tcfg.config_from_id(cid)) == cid


@pytest.mark.parametrize("cfg", [(1, 0, 0, 64), (1, 1, 1, 64), (8, 3, 1, 32)])
def test_phy_tables_equal_the_reference_tables(cfg):
    n = jfs.FrameSpec(jcfg.FrameConfig(*cfg)).inner_bits
    ref = {
        "templates": jdet.templates_time(),
        "delayed_templates": jdet._delayed_templates(),
        "timing_bank30": jsync._timing_bank30(),
        "timing_bank65": jsync._timing_bank65(),
        "preamble": jmseq.preamble_symbols(),
        "rrc_taps": jrrc.matched_taps(),
        "constellation": jmodem.constellation(cfg[0]),
        "interleave_perm": jfs.interleave_perm(n),
        "interleave_inv": jfs.interleave_inv(n),
    }
    got = ttables.numpy_tables(tcfg.FrameConfig(*cfg))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the reference's tables, handed to the port, give the same tensors
    a = ttables.tables_from_numpy(ref, device="cpu")
    b = ttables.phy_tables(tcfg.FrameConfig(*cfg), device="cpu")
    for k in ref:
        np.testing.assert_array_equal(getattr(a, k).numpy(), getattr(b, k).numpy(), err_msg=k)


@pytest.mark.parametrize("modulation", range(11))
def test_constellations_equal(modulation):
    np.testing.assert_array_equal(
        jmodem.constellation(modulation), tmodem.constellation(modulation))
    assert jmodem.is_differential(modulation) == tmodem.is_differential(modulation)
    assert jmodem.rotational_symmetry(modulation) == tmodem.rotational_symmetry(modulation)


@pytest.mark.parametrize("length", [19, 35, 67, 259])
def test_crc24_matrices_equal(length):
    fa, ca = jcrc._crc_matrix(length, jcrc.CRC24_POLY, 24, jcrc.CRC24_INIT)
    fb, cb = tcrc.crc24_matrix(length)
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(ca, cb)


def test_golay_and_trellis_tables_equal():
    np.testing.assert_array_equal(jblock._golay_b_matrix(), tblock._golay_b_matrix())
    np.testing.assert_array_equal(jblock.golay2412().p, tblock.golay2412().p)
    for a, b in zip(jconv._trellis_tables(), tconv._trellis_tables()):
        np.testing.assert_array_equal(a, b)
    from liquiddsp_tpu.kernels.viterbi import _branch_consts

    np.testing.assert_array_equal(
        _branch_consts(*jconv._trellis_tables()), tconv.branch_signs())


@pytest.mark.parametrize("inner", range(7))
def test_code_lengths_equal(inner):
    for nbits in (7, 96, 536, 1080, 4153):
        assert jconv.num_coded_bits(nbits, inner) == tconv.num_coded_bits(nbits, inner)
        if inner:
            np.testing.assert_array_equal(
                jconv._keep_mask(nbits + 6, inner), tconv._keep_mask(nbits + 6, inner))
    for outer in range(8):
        for msg_len in (1, 22, 35, 67, 223, 224, 259, 500):
            assert jreg.outer_encoded_bits(msg_len, outer) == treg.outer_encoded_bits(
                msg_len, outer), (msg_len, outer)
    for msg_len in (1, 223, 224, 446, 447):
        assert jrs.block_sizes(msg_len) == trs.block_sizes(msg_len)
    for outer in (1, 3, 4, 5, 6, 7):
        c, ct = jreg._block_code(outer), treg._block_code(outer)
        assert (c.n, c.k) == (ct.n, ct.k)
        np.testing.assert_array_equal(c.p, ct.p)
