"""The closed adaptation loop: TX -> AWGN channel -> FlexRx -> cognitive
engine -> the next config of every channel.

Counterpart of ``bench/adapt_loop.py`` (``_loop``). The reference's loop is
one packet at a time through GR message ports (python/cognitive_engine.py:
78-149, lib/flex_rx_impl.cc:203-253). Here one generation carries a BATCH of
channels, each with its OWN current config (every engine decision is
played):

1. the payloads of each config group are framed with one ``framegen`` call
   (payloads from numpy ``default_rng(seed)``, as in the JAX code; eager
   PyTorch compiles nothing, so groups are not padded to powers of 2);
2. AWGN is added on the device from a seeded ``torch.Generator`` there (its
   noise differs from ``jax.random``'s in its samples, not its power); with
   ``dynamic=True`` the SNR follows the engine's ``get_number()`` schedule;
3. ``FlexRx.work_submit(x, expected_configs=...)`` queues the front end and
   the speculative payload decode of the commanded configs, and
   ``work_complete`` finishes the block;
4. a frame that was lost reports a failure on the config it was commanded;
5. the engine consumes the generation in one ``handle_batch``.

With ``pipeline=True``, generation N+1 is queued before generation N is
completed, so the engine's feedback is one generation late.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.engine.cognitive_engine import CognitiveEngineBlock
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy import framegen
from liquiddsp_tpu_torch.runtime.blocks import FlexRx

LEAD = 256  # samples before each frame
FEEDBACK_KEYS = ("header_valid", "payload_valid", "modulation", "inner_code", "outer_code")


def block_samples(payload_len: int) -> int:
    """Samples a channel of one generation: lead-in, the longest frame at
    ``payload_len``, 256 after it."""
    return LEAD + fs.max_frame_spec(payload_len).frame_samples + 256


def channel_block(cfgs, payloads: np.ndarray, snr_db: float, t_block: int,
                  gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """[B, t_block] complex64: channel b carries one frame of ``cfgs[b]``
    with payload ``payloads[b]`` at LEAD, plus AWGN at ``snr_db`` over the
    mean power of its config group's frames."""
    b, payload_len = payloads.shape
    x = torch.zeros((b, t_block), dtype=torch.complex64, device=device)
    sigma = torch.zeros((b, 1), dtype=torch.float32, device=device)
    groups: dict[tuple, list[int]] = {}
    for ch, c in enumerate(cfgs):
        groups.setdefault(tuple(c), []).append(ch)
    for (m, i, o), chans in groups.items():
        cfg = FrameConfig(m, i, o, payload_len)
        frames = framegen.framegen(payloads[chans], cfg, device=device)  # [G, f]
        rows = torch.as_tensor(chans, dtype=torch.int64).to(device)
        x[rows, LEAD : LEAD + frames.shape[1]] = frames
        p_sig = torch.mean(torch.abs(frames) ** 2)
        sigma[rows] = torch.sqrt(p_sig / (2 * 10 ** (snr_db / 10)))
    noise = torch.complex(
        torch.randn((b, t_block), generator=gen, device=device),
        torch.randn((b, t_block), generator=gen, device=device),
    )
    return x + sigma * noise


def adapt_loop(
    batch: int = 64,
    iters: int = 50,
    snr_db: float = 15.0,
    payload_len: int = 32,
    ce_type: str = "epsilon_greedy",
    dynamic: bool = False,
    pipeline: bool = False,
    seed: int = 0,
    *,
    device: torch.device | str | None = None,
) -> dict:
    """One deterministic run of the loop on ``device`` (``None``: the GPU).

    Returns ``bench/adapt_loop.py``'s keys (``packets``, ``payload_valid``,
    ``wall_s``, ``packets_per_sec``, ``pipeline``, ``stage_s``,
    ``configs_visited``, ``final_configs``, ``block_samples``,
    ``samples_per_sec``) and besides: ``payload_exact``, the valid frames
    whose bytes equal what was sent; ``commanded``, ``feedback`` and
    ``decisions``, one list a generation of each channel's commanded config,
    the packet_info dict fed to the engine and the engine's next config.
    """
    dev = resolve_device(device)
    t_block = block_samples(payload_len)
    rx = FlexRx(max_payload_len=payload_len, max_frames_per_block=2, device=dev)
    ce = CognitiveEngineBlock(
        ce_type=ce_type, channel="nonstationary" if dynamic else "stationary", seed=seed)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = {"t_txch": 0.0, "t_rx": 0.0, "t_ce": 0.0, "n_packets": 0, "n_valid": 0,
             "n_exact": 0}
    log = {"commanded": [], "feedback": [], "decisions": []}
    cfgs = [(1, 0, 0)] * batch  # each channel's (mod, inner, outer)

    def dispatch():
        """TX + channel + the front end of one generation on the CURRENT
        configs; returns what ``complete`` needs."""
        payloads = rng.integers(0, 256, (batch, payload_len), dtype=np.uint8)
        snr = snr_db
        if dynamic:
            snr = 10 * math.log10((0.05 / (2 * ce.get_number())) ** 2)
        t0 = time.perf_counter()
        x = channel_block(cfgs, payloads, snr, t_block, gen, dev)
        handle = rx.work_submit(x, expected_configs=[(*c, payload_len) for c in cfgs])
        state["t_txch"] += time.perf_counter() - t0
        return handle, list(cfgs), payloads

    def complete(handle, used, payloads):
        """Finish one generation and feed the engine. ``used`` is the config
        each channel was COMMANDED: with the pipeline it differs from the
        current ones, and a lost frame reports failure on it."""
        nonlocal cfgs
        t1 = time.perf_counter()
        infos = rx.work_complete(handle)
        t2 = time.perf_counter()
        first: dict[int, dict] = {}
        for info in infos:
            first.setdefault(info["batch"], info)
        fbs = []
        for ch in range(batch):
            info = first.get(ch)
            if info is not None:
                fb = {k: info[k] for k in FEEDBACK_KEYS}
                state["n_valid"] += info["payload_valid"]
                state["n_exact"] += int(bool(info["payload_valid"]) and np.array_equal(
                    info["payload"], payloads[ch]))
            else:
                m, i, o = used[ch]
                fb = {"header_valid": 0, "payload_valid": 0,
                      "modulation": m, "inner_code": i, "outer_code": o}
            fbs.append(fb)
        nxt = list(cfgs)
        decisions = ce.handle_batch(fbs)
        for ch, d in enumerate(decisions):
            if d:
                nxt[ch] = (d["modulation"], d["inner_code"], d["outer_code"])
        cfgs = nxt
        state["t_rx"] += t2 - t1
        state["t_ce"] += time.perf_counter() - t2
        state["n_packets"] += batch
        log["commanded"].append(used)
        log["feedback"].append(fbs)
        log["decisions"].append(decisions)

    t_all0 = time.perf_counter()
    if pipeline:
        pending = None
        for _ in range(iters):
            nxt = dispatch()
            if pending is not None:
                complete(*pending)
            pending = nxt
        complete(*pending)
    else:
        for _ in range(iters):
            complete(*dispatch())
    wall = time.perf_counter() - t_all0
    return {
        "packets": state["n_packets"],
        "payload_valid": state["n_valid"],
        "payload_exact": state["n_exact"],
        "wall_s": wall,
        "packets_per_sec": state["n_packets"] / wall,
        "pipeline": bool(pipeline),
        "stage_s": {"tx_channel": state["t_txch"], "rx": state["t_rx"],
                    "engine": state["t_ce"]},
        "configs_visited": len({r.config_id for r in ce.store.rx_log}),
        "final_configs": sorted(set(cfgs)),
        "block_samples": t_block,
        "samples_per_sec": state["n_packets"] * t_block / wall,
        **log,
    }

