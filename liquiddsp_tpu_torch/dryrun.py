"""A dry run of the time-sharded receiver on adversarial small streams.

    python3 -c "import liquiddsp_tpu_torch as p; p.dryrun_sharded(8)"

The counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``: for each of the four config classes (plain QPSK,
QPSK + V27 + Golay, differential DQPSK, QAM64 + Reed-Solomon) a noiseless
stream with one frame inside every time shard and one frame straddling EVERY
internal shard boundary, on two channels. The
exact frame count and every payload byte are asserted, and ``LinkMetrics``
must agree with the host's count.
"""

from __future__ import annotations

import torch

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.parallel.halo import sharded_framesync
from liquiddsp_tpu_torch.parallel.mesh import make_mesh
from liquiddsp_tpu_torch.phy import framegen
from liquiddsp_tpu_torch.utils.metrics import LinkMetrics

CONFIG_CLASSES = (
    ("qpsk", FrameConfig(1, 0, 0, 64)),
    ("qpsk_v27_golay", FrameConfig(1, 1, 1, 64)),
    ("dqpsk", FrameConfig(5, 0, 0, 64)),
    ("qam64_rs", FrameConfig(10, 0, 2, 64)),
)
N_CH = 2


def straddle_stream(cfg: FrameConfig, n_time: int, gen: torch.Generator, dev: torch.device):
    """(x [N_CH, n_time*T_local], {(row, start): payload}, T_local): an
    interior frame per shard at ``off`` and a frame across every internal
    boundary, laid out so that no two frames overlap."""
    f = framegen.frame_length(cfg)
    off = f // 2 + 256
    t_local = max(1536, ((off + 3 * f // 2 + 512) // 256) * 256)
    starts = sorted(
        [i * t_local + off for i in range(n_time)]
        + [i * t_local - f // 2 for i in range(1, n_time)]
    )
    payloads = torch.randint(
        0, 256, (N_CH * len(starts), cfg.payload_len), generator=gen, device=dev,
        dtype=torch.int32,
    ).to(torch.uint8)
    frames = framegen.framegen(payloads, cfg, device=dev).reshape(N_CH, len(starts), f)
    x = torch.zeros((N_CH, n_time * t_local), dtype=torch.complex64, device=dev)
    expected = {}
    sent = payloads.reshape(N_CH, len(starts), -1).cpu()
    for b in range(N_CH):
        for i, s in enumerate(starts):
            x[b, s : s + f] = frames[b, i]
            expected[(b, s)] = sent[b, i]
    return x, expected, t_local


def dryrun_sharded(n_time: int, device: torch.device | str | None = None) -> None:
    """Run the sharded receiver over ``n_time`` logical time shards of one
    device (``None``: the GPU) for all four config classes; raises
    ``AssertionError`` on any frame missing, doubled, misplaced or wrong."""
    dev = resolve_device(device)
    mesh = make_mesh(n_time=n_time, n_ch=N_CH, devices=[dev])
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    counts = {}
    for name, cfg in CONFIG_CLASSES:
        x, expected, t_local = straddle_stream(cfg, n_time, gen, dev)
        res = sharded_framesync(x, cfg, mesh, max_frames_per_shard=3)
        metrics = LinkMetrics.from_results(res, x.shape[1])
        pv, start, payload = res.payload_valid.cpu(), res.start.cpu(), res.payload.cpu()
        decoded = {}
        for b, k in torch.nonzero(pv).tolist():
            key = (b, int(start[b, k]))
            assert key not in decoded, f"{name}: frame {key} decoded twice"
            decoded[key] = payload[b, k]
        assert set(decoded) == set(expected), (
            f"{name}: missing {sorted(set(expected) - set(decoded))[:4]}, "
            f"extra {sorted(set(decoded) - set(expected))[:4]}"
        )
        for key, sent in expected.items():
            assert torch.equal(decoded[key], sent), f"{name}: payload mismatch at {key}"
        assert int(metrics.payloads_valid) == len(expected), f"{name}: payloads_valid"
        assert int(metrics.frames_detected) == int(res.mask.sum()) == len(expected), (
            f"{name}: frames_detected {int(metrics.frames_detected)}"
        )
        assert int(metrics.samples) == n_time * t_local
        counts[name] = len(expected)
    print(
        f"dryrun_sharded: mesh=(time={n_time}, ch={N_CH}) on {dev}, "
        f"{N_CH * (n_time - 1)} boundary straddles per class, metrics OK, config "
        "classes bit-exact: "
        + ", ".join(f"{n}={c} frames" for n, c in counts.items())
    )
