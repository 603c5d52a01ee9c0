"""The 616-config loopback of the port: every (modulation, inner, outer)
config end to end through the self-describing receiver.

Counterpart of ``bench/config_space.py``. Frames of ``group`` configs at a
time share one mixed-config [group, T] block that ``runtime.blocks.FlexRx``
decodes: the config-independent front end (``sync_common``) runs once per
block, and each config's payload back end (``decode_payload_symbols``) once
per config. A config counts as ok only if each of its frames decoded once,
with the config and payload that were sent.

Layout and samples are the reference's: per channel, frames in slots of
``max_frame_spec(payload_len).frame_samples + LEAD`` samples after a lead of
``LEAD``; AWGN at 18 + 2 * bits_per_symbol dB, a decode margin for the
densest uncoded constellations, not a sensitivity measurement; payloads and
noise drawn from numpy's generator in the reference's order, which restarts
at ``seed`` in each of its ``shards`` parts of the config list. So a sweep
decodes the very samples of the reference's recorded run with the same
``seed`` and ``shards`` (``bench/CONFIG_SPACE.json``: 8 shards;
``bench/CONFIG_SPACE_LONG.json``: 4).

    python3 -c "from liquiddsp_tpu_torch.config_space import config_space_loopback as f; \\
        r = f(payload_len=16, mods=[1], device='cpu'); print(sum(r.values()), len(r))"
"""

from __future__ import annotations

import numpy as np
import torch

from liquiddsp_tpu_torch.core.config import (
    MOD_BPS,
    NUM_INNER_CODES,
    NUM_MODULATIONS,
    NUM_OUTER_CODES,
    FrameConfig,
)
from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy import framegen
from liquiddsp_tpu_torch.runtime.blocks import FlexRx

LEAD = 256


def slot_samples(payload_len: int) -> int:
    """Samples from one frame start to the next in a loopback block."""
    return fs.max_frame_spec(payload_len).frame_samples + LEAD


def loopback_block(configs, payload_len: int, n_frames: int, t_block: int,
                   rng: np.random.Generator, device: torch.device | str | None = None):
    """A mixed-config block: row c carries ``n_frames`` frames of
    ``configs[c]`` = (mod, inner, outer) with random payloads, each at the
    start of its slot, plus AWGN at 18 + 2 * bits_per_symbol dB. For each row
    in turn, ``rng`` draws the payloads, then the noise's real and imaginary
    parts, as the reference does; the frames are made on ``device``.

    Returns (x [len(configs), t_block] complex64 on ``device``, payloads
    [len(configs), n_frames, payload_len] uint8 numpy)."""
    dev = resolve_device(device)
    slot = slot_samples(payload_len)
    if LEAD + n_frames * slot > t_block:
        raise ValueError(f"{n_frames} slots of {slot} samples do not fit {t_block}")
    x = np.zeros((len(configs), t_block), dtype=np.complex64)
    sent = np.zeros((len(configs), n_frames, payload_len), dtype=np.uint8)
    for ch, (m, i, o) in enumerate(configs):
        sent[ch] = rng.integers(0, 256, (n_frames, payload_len), dtype=np.uint8)
        frames = framegen.framegen(torch.from_numpy(sent[ch]).to(dev),
                                   FrameConfig(m, i, o, payload_len), device=dev).cpu().numpy()
        x[ch, LEAD : LEAD + n_frames * slot].reshape(n_frames, slot)[:, : frames.shape[1]] = frames
        snr_db = 18.0 + 2.0 * MOD_BPS[m]
        sigma = np.sqrt(np.mean(np.abs(frames) ** 2) / (2 * 10 ** (snr_db / 10)))
        x[ch] += sigma * (
            rng.standard_normal(t_block) + 1j * rng.standard_normal(t_block)
        ).astype(np.complex64)
    return torch.from_numpy(x).to(dev), sent


def reference_defect(m: int, i: int, o: int) -> bool:
    """QAM16/32/64 with both an inner and an outer code: the JAX package fails
    about a fifth of such frames with no noise at payload 64."""
    return m >= 8 and i > 0 and o > 0


def mixed_stream(batch: int, block: int, payload_len: int, seed: int,
                 device: torch.device | str | None = None):
    """The self-describing receiver's load: a different config on each of
    ``batch`` channels, in the loopback layout with as many frames a channel
    as ``block`` samples hold. The configs are the first seeded draw of
    ``batch`` distinct ones outside the reference-defect class that covers
    every modulation, inner code and outer code.

    Returns (configs, x [batch, block] complex64 on ``device``, payloads
    [batch, frames, payload_len] uint8 numpy)."""
    allowed = [(m, i, o) for m in range(NUM_MODULATIONS) for i in range(NUM_INNER_CODES)
               for o in range(NUM_OUTER_CODES) if not reference_defect(m, i, o)]
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        pick = [allowed[j] for j in rng.choice(len(allowed), batch, replace=False)]
        if [len({c[a] for c in pick}) for a in range(3)] == [
                NUM_MODULATIONS, NUM_INNER_CODES, NUM_OUTER_CODES]:
            break
    else:
        raise ValueError(f"no draw of {batch} configs covers every modulation and code")
    n_frames = (block - LEAD) // slot_samples(payload_len)
    x, payloads = loopback_block(pick, payload_len, n_frames, block, rng, device)
    return pick, x, payloads


def frame_outcomes(infos: list[dict], configs, payloads: np.ndarray, payload_len: int):
    """Hold FlexRx's packet_info dicts against a ``loopback_block``: each
    info belongs to the slot its ``start`` lies in. Returns (ok [B, n_frames]
    bool: that slot's frame decoded once with the config and payload sent,
    false [B, n_frames] int: infos that passed their CRC with another config
    or payload, or a second time)."""
    slot = slot_samples(payload_len)
    b, n_frames = payloads.shape[:2]
    seen = np.zeros((b, n_frames), dtype=np.int64)
    ok = np.zeros((b, n_frames), dtype=bool)
    false = np.zeros((b, n_frames), dtype=np.int64)
    for info in infos:
        ch = info["batch"]
        j = min(max((info["start"] - LEAD + slot // 2) // slot, 0), n_frames - 1)
        seen[ch, j] += 1
        right = (
            (info["modulation"], info["inner_code"], info["outer_code"]) == tuple(configs[ch])
            and info["payload_len"] == payload_len
            and bool(info["payload_valid"])
            and np.array_equal(np.asarray(info["payload"]), payloads[ch, j])
        )
        if right and seen[ch, j] == 1:
            ok[ch, j] = True
        elif info["payload_valid"]:
            false[ch, j] += 1
    return ok, false


def config_space_loopback(
    payload_len: int = 32,
    frames_per_config: int = 2,
    group: int = 8,
    mods=None,
    seed: int = 0,
    shards: int = 8,
    configs=None,
    device: torch.device | str | None = None,
) -> dict[str, bool]:
    """Decode ``frames_per_config`` frames of every config in blocks of
    ``group`` configs through ``FlexRx(max_payload_len=payload_len,
    max_frames_per_block=frames_per_config + 2)`` on ``device``.

    The configs are ``configs`` ((mod, inner, outer) triples) or else all
    those of the modulations ``mods`` (all 11 by default). Returns
    {"m_i_o": ok}: ok when the config's row held exactly one packet info a
    frame and each carried the config and payload sent (the reference's
    rule). ``seed`` and ``shards`` fix the samples (module docstring)."""
    dev = resolve_device(device)
    if configs is None:
        keep = range(NUM_MODULATIONS) if mods is None else sorted({int(m) for m in mods})
        configs = [(m, i, o) for m in keep
                   for i in range(NUM_INNER_CODES) for o in range(NUM_OUTER_CODES)]
    nf = frames_per_config
    t_block = nf * slot_samples(payload_len) + LEAD
    rx = FlexRx(max_payload_len=payload_len, max_frames_per_block=nf + 2, device=dev)
    per = -(-len(configs) // shards)
    results: dict[str, bool] = {}
    for s0 in range(0, len(configs), per):
        rng = np.random.default_rng(seed)
        part = configs[s0 : s0 + per]
        for g0 in range(0, len(part), group):
            cfgs = part[g0 : g0 + group]
            x, payloads = loopback_block(cfgs, payload_len, nf, t_block, rng, dev)
            infos = rx.work(x)
            ok, false = frame_outcomes(infos, cfgs, payloads, payload_len)
            n_infos = np.bincount([d["batch"] for d in infos], minlength=len(cfgs))
            for ch, (m, i, o) in enumerate(cfgs):
                results[f"{m}_{i}_{o}"] = bool(
                    ok[ch].all() and not false[ch].any() and n_infos[ch] == nf)
    return results
