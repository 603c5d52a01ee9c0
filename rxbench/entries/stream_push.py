"""``StreamingRx.push``: the stream handed over in pieces of ``push_len``
samples a channel, as a flowgraph's block receives it; a chunk's results come
back from the push that completes it."""

from __future__ import annotations

from rxbench.entries import stream_step

slots = stream_step.slots
shapes = stream_step.shapes
reference_frames = stream_step.reference_frames


class Receiver(stream_step.Receiver):
    def __init__(self, cfg, traffic, chunks, device):
        super().__init__(cfg, traffic, chunks, device)
        self.host = chunks.numpy()  # views of the pool, as numpy arrays
        n = traffic["push_len"]
        if traffic["chunk_len"] % n:
            raise ValueError(f"push_len {n} does not divide chunk_len {traffic['chunk_len']}")
        self.pieces = [slice(a, a + n) for a in range(0, traffic["chunk_len"], n)]

    def feed(self, i: int, spans):
        chunk = self.host[i]
        for s in self.pieces:
            with spans("ingest") as t0:
                out = self.rx.push(chunk[:, s])
        if len(out) != 1:
            raise RuntimeError(f"push gave {len(out)} results for one chunk")
        return t0, out[0]
