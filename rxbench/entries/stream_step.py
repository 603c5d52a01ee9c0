"""``StreamingRx.step``: one chunk a call, replayed as the program's graph on
a card. The chunk is handed over from pinned host memory, as a radio
front end's ring buffer would hold it."""

from __future__ import annotations

from rxbench import frame as fr
from rxbench import windows


def slots(cfg: fr.Config, traffic: dict) -> int:
    return fr.slots_for(cfg, traffic["chunk_len"])


def shapes(cfg: fr.Config, traffic: dict, frames: int) -> dict:
    """The stages' work in a chunk that carries ``frames`` frames, as the
    input needs it: a lag of the correlator a new sample (the overlap's are
    the chunk before's), a Viterbi decode a frame (not a slot)."""
    out = {"correlator": (traffic["batch"], traffic["chunk_len"])}
    if cfg.inner_code == 1:
        out["viterbi"] = (frames, cfg.outer_bits + fr.V27_TAIL)
    return out


def reference_frames(pool, i, cfg, traffic, q, device) -> dict:
    return windows.stream_frames(pool, i, cfg, slots(cfg, traffic), q, device)


class Receiver:
    def __init__(self, cfg: fr.Config, traffic: dict, chunks, device):
        from liquiddsp_tpu_torch.core.config import FrameConfig
        from liquiddsp_tpu_torch.runtime.stream import StreamingRx

        self.chunks = chunks  # [N, B, L] host (pinned on a card)
        self.rx = StreamingRx(
            FrameConfig(cfg.modulation, cfg.inner_code, cfg.outer_code, cfg.payload_len),
            traffic["batch"], traffic["chunk_len"], max_frames_per_chunk=slots(cfg, traffic),
            threshold=cfg.threshold, device=device)

    def feed(self, i: int, spans):
        """(host time of the hand-over, the chunk's results)."""
        with spans("entry") as t0:
            res = self.rx.step(self.chunks[i])
        return t0, res
