"""Run one benchmark cell:

    python3 -m rxbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s`` from the start of this process): the cell's
stream drawn from the seed on the card by the benchmark's transmitter and
put in pinned host memory, the program's receiver built, and the pool's
chunks run through it ``warm_cycles`` times (the kernel library built or
loaded, every graph captured, the carry in its steady state). The window
then hands the chunks over round the pool in a closed loop for
``--seconds``: each chunk after the results of the one before are on the
host. With ``--trace 1`` a few steady chunks in the window run under the
profiler and the run reports the per-layer metrics; with ``--trace 0`` the
end-to-end ones. After the window, the program freed, the reference decodes
every pool chunk and every chunk of the window is held against it.

The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error and the last key of
that object. A run without a card, or with fewer than the cell asks for,
exits 2 and prints no result; one that finds JAX or the JAX package loaded
exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from rxbench import compare, isolation, reference, spec, trace, tx, windows  # noqa: E402

FETCHED = ("mask", "header_valid", "payload_valid", "modulation", "inner_code", "outer_code",
           "payload_len", "header_user", "payload", "evm", "rssi", "cfo", "start")


PROFILED = (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)


class NoCard(RuntimeError):
    pass


class Spans:
    """Host spans around the calls into the program: each records its start
    and length, and under the profiler marks the trace."""

    def __init__(self):
        self.records: list[tuple[str, float, float]] = []
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, label: str):
        rf = (torch.profiler.record_function(trace.SPAN_PREFIX + label) if self.tracing
              else contextlib.nullcontext())
        with rf:
            t0 = time.perf_counter()
            try:
                yield t0
            finally:
                self.records.append((label, t0, time.perf_counter() - t0))


class Fetcher:
    """Results to the host as the farm's users read them: every field but
    the symbols, copied into pinned buffers on a card, one synchronise."""

    def __init__(self, device: torch.device):
        self.device = device
        self.bufs: dict = {}

    def __call__(self, res) -> dict:
        out = {}
        for f in FETCHED:
            t = getattr(res, f)
            if self.device.type != "cuda":
                out[f] = t
                continue
            key = (f, tuple(t.shape), t.dtype)
            if key not in self.bufs:
                self.bufs[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out[f] = self.bufs[key].copy_(t, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return {f: v.numpy().copy() for f, v in out.items()}


@dataclasses.dataclass
class Record:
    """What the metric readers read."""

    cell: spec.Cell
    chunk_samples: int
    setup_s: float
    window_s: float = 0.0
    latencies: list = dataclasses.field(default_factory=list)  # s, untraced chunks
    spans: dict = dataclasses.field(default_factory=dict)  # label -> [s a chunk], untraced chunks
    n_chunks: int = 0
    stage_work: dict = dataclasses.field(default_factory=dict)  # stage -> [shape a traced chunk]
    trace: trace.Summary | None = None


def resolve_device(cell: spec.Cell, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        raise NoCard(f"{cell.name} asks for {cell.chips} cards, {torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, *, device=None,
             traffic_override: dict | None = None) -> dict:
    """One run of ``workload``; returns the result line's object."""
    cell = spec.load_cell(workload, traffic_override)
    dev = resolve_device(cell, device)
    cfg, traffic = cell.config, cell.traffic
    n_pool, batch, chunk_len = traffic["pool_chunks"], traffic["batch"], traffic["chunk_len"]

    # set-up: the stream, the receiver, the warm cycles
    pool = tx.make_pool(cfg, batch, chunk_len, n_pool, seed, dev)
    host = pool.chunks.cpu()
    pool.chunks = None
    if dev.type == "cuda":
        host = host.pin_memory()
        torch.cuda.empty_cache()  # the peak is the program's from here on
        torch.cuda.reset_peak_memory_stats(dev)
    pool.chunks = host
    rx = cell.entry.Receiver(cfg, traffic, host, dev)
    fetch = Fetcher(dev)
    spans = Spans()
    warm = traffic["warm_cycles"] * n_pool
    for j in range(warm):
        fetch(rx.feed(j % n_pool, spans)[1])
    if trace_on:  # the profiler's first start sets up its tracing; not in the window
        with torch.profiler.profile(activities=PROFILED):
            fetch(rx.feed(0, spans)[1])
        for i in range(1, n_pool):
            fetch(rx.feed(i, spans)[1])
        warm += n_pool
    spans.records.clear()
    rec = Record(cell, batch * chunk_len, time.perf_counter() - T_START)
    isolation.check("at the start of the window")

    # the window
    chunks: list[compare.Chunk] = []
    traced: set[int] = set()
    prof = res = None
    j = 0
    t_begin = time.perf_counter()
    t_trace = t_begin + seconds / 4
    while True:
        now = time.perf_counter()
        if now - t_begin >= seconds and not spans.tracing:
            break
        if trace_on and prof is None and now >= t_trace:
            prof = torch.profiler.profile(activities=PROFILED)
            prof.start()
            spans.tracing = True
        i = j % n_pool
        n_rec = len(spans.records)
        t0, res = rx.feed(i, spans)
        with spans("fetch"):
            fields = fetch(res)
        t1 = time.perf_counter()
        chunks.append(compare.Chunk(i, fields, int(res.epoch)))
        if spans.tracing:
            traced.add(j)
            if len(traced) >= traffic["trace_chunks"]:
                prof.stop()
                spans.tracing = False
        else:
            rec.latencies.append(t1 - t0)
            for label in {r[0] for r in spans.records[n_rec:]}:
                rec.spans.setdefault(label, []).append(
                    sum(r[2] for r in spans.records[n_rec:] if r[0] == label))
        j += 1
    rec.window_s = time.perf_counter() - t_begin
    rec.n_chunks = j
    isolation.check("once the window closed")

    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    del rx, res
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if trace_on:
        if prof is None or not traced:
            raise RuntimeError("the window ended before a chunk was traced")
        rec.trace = trace.summarize(*trace.events_of(prof), chunks=len(traced))
        del prof
        kept = windows.frames_by_chunk(pool.layout, cfg.overlap, chunk_len)
        for j in sorted(traced):
            for stage, shape in cell.entry.shapes(cfg, traffic, int(kept[j % n_pool])).items():
                rec.stage_work.setdefault(stage, []).append(shape)

    # correctness: every chunk of the window against the reference
    numbers, attempted, failed = judge(cell, pool, chunks, warm, dev,
                                       reference.Precision(cfg.precision))
    ok, rows = compare.held(numbers, cell.limits)
    metrics = {}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        v = m.reader.read(rec)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": memory_peak}
    out = {"correct": ok, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_info}
    if rec.trace is not None:
        device_info["busy_s"] = rec.trace.busy_s
        device_info["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown()
    out["numbers"] = numbers  # every number the comparison gives; main prints it apart
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return out


def judge(cell: spec.Cell, pool: tx.Pool, chunks: list[compare.Chunk], n_before: int, dev,
          q: reference.Precision) -> tuple[dict, int, int]:
    """(the numbers compared, frames attempted, frames failed) of the
    window's chunks, which followed ``n_before`` chunks of set-up, against
    the reference decoding their pool chunks."""
    cfg, traffic = cell.config, cell.traffic
    circle = pool.n_chunks * traffic["chunk_len"]
    want = {i: cell.entry.reference_frames(pool, i, cfg, traffic, q, dev)
            for i in sorted({c.index for c in chunks})}
    diff = compare.Differences()
    frames = []
    for c in chunks:
        got = compare.program_frames(c, circle)
        compare.differ(got, want[c.index], circle, diff)
        frames.append(got)
    # the stream the window's chunks kept frames from
    first = n_before * traffic["chunk_len"] - cfg.overlap
    end = first + len(chunks) * traffic["chunk_len"]
    attempted, failed = compare.account(frames, pool.layout, pool.payload, pool.user, first, end)
    return diff.numbers(), attempted, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(f"rxbench: {e}", file=sys.stderr)
        return 2
    except isolation.Loaded as e:
        print(f"rxbench: {e}", file=sys.stderr)
        return 3
    print(f"numbers {json.dumps(out.pop('numbers'))}", file=sys.stderr)
    print(f"correct {out['correct']} attempted {out['attempted']} failed {out['failed']}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
