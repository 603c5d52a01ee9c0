"""The control of a cell's correctness check, the upper readings of the
limits in ``limits/<cell>.json``:

    python3 -m rxbench.control --workload <cell> --seeds 1,2,3

For each seed: the reference computed in bfloat16, put in the program's
place, held against the reference in float32 on every chunk of the cell's
pool by the comparison a run makes. It prints every number that comparison
gives, one JSON line a seed; under the limits the control has to come out
as not correct. (The lower readings are the numbers the program's own runs
print.)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from rxbench import compare, reference, run, spec, tx


def control_numbers(cell: spec.Cell, seed: int, device) -> dict:
    """The numbers compared, with the bfloat16 reference as the program."""
    cfg, traffic = cell.config, cell.traffic
    pool = tx.make_pool(cfg, traffic["batch"], traffic["chunk_len"], traffic["pool_chunks"],
                        seed, device)
    pool.chunks = pool.chunks.cpu()
    circle = pool.n_chunks * traffic["chunk_len"]
    diff = compare.Differences()
    for i in range(pool.n_chunks):
        want = cell.entry.reference_frames(pool, i, cfg, traffic, reference.Precision("float32"),
                                           device)
        got = cell.entry.reference_frames(pool, i, cfg, traffic, reference.Precision("bfloat16"),
                                          device)
        compare.differ(got, want, circle, diff)
    return diff.numbers()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    dev = run.resolve_device(cell, None)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        nums = control_numbers(cell, seed, dev)
        ok, _ = compare.held(nums, cell.limits)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": ok,
                          "numbers": nums, "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
