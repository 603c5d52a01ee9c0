"""``ShardedStreamingRx.step`` over ``make_mesh(n_time)`` on one card: each
chunk's window cut into ``n_time`` time shards by the halo kernel and decoded
in one eager ``framesync_fixed`` call."""

from __future__ import annotations

from rxbench import frame as fr
from rxbench import windows


def _t_local(cfg: fr.Config, traffic: dict) -> int:
    real = cfg.overlap + traffic["chunk_len"]
    return (real + (-real) % traffic["n_time"]) // traffic["n_time"]


def slots(cfg: fr.Config, traffic: dict) -> int:
    return fr.slots_for(cfg, _t_local(cfg, traffic))


def shapes(cfg: fr.Config, traffic: dict, frames: int) -> dict:
    """As ``stream_step.shapes``, and the halo: every sample of the padded
    window read once, every sample of the shard windows written once."""
    b, n = traffic["batch"], traffic["n_time"]
    t_local = _t_local(cfg, traffic)
    out = {"correlator": (b, traffic["chunk_len"]),
           "halo": (b, n * t_local, n, t_local + cfg.overlap)}
    if cfg.inner_code == 1:
        out["viterbi"] = (frames, cfg.outer_bits + fr.V27_TAIL)
    return out


def reference_frames(pool, i, cfg, traffic, q, device) -> dict:
    return windows.sharded_frames(pool, i, cfg, traffic["n_time"], slots(cfg, traffic), q,
                                  device)


class Receiver:
    def __init__(self, cfg: fr.Config, traffic: dict, chunks, device):
        from liquiddsp_tpu_torch.core.config import FrameConfig
        from liquiddsp_tpu_torch.parallel.mesh import make_mesh
        from liquiddsp_tpu_torch.runtime.distributed_stream import ShardedStreamingRx

        self.chunks = chunks
        mesh = make_mesh(n_time=traffic["n_time"], n_ch=1, devices=[device])
        self.rx = ShardedStreamingRx(
            FrameConfig(cfg.modulation, cfg.inner_code, cfg.outer_code, cfg.payload_len),
            mesh, traffic["batch"], traffic["chunk_len"],
            max_frames_per_shard=slots(cfg, traffic), threshold=cfg.threshold)

    def feed(self, i: int, spans):
        with spans("entry") as t0:
            res, _ = self.rx.step(self.chunks[i])
        return t0, res
