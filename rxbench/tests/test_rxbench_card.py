"""On the card: a short run of each cell is correct, and its control is not.

Run on a machine with an NVIDIA card: ``python3 -m pytest rxbench/tests -m card``.
The cells run at their own widths with a smaller pool, each in a process of
its own as the benchmark runs them (a second receiver's graph capture after
the first run was freed fails inside PyTorch's pinned-memory allocator); the
control at a third of a cell's channels."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from rxbench import compare, control, spec

ROOT = Path(__file__).resolve().parents[2]
RUN = ("import json, sys, torch; from rxbench import run; "
       "out = run.run_cell(sys.argv[1], 2**31 + 3, 2.0, False, device=torch.device('cuda', 0), "
       "traffic_override={'pool_chunks': 3}); "
       "print(json.dumps({k: out[k] for k in ('correct', 'attempted', 'failed', 'checks')}))")

CELLS = ("v27golay.chunks", "uncoded.chunks", "v27golay.push4096", "v27golay.sharded8")


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_short_run_is_correct(card, workload):
    p = subprocess.run([sys.executable, "-c", RUN, workload], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload):
    cell = spec.load_cell(workload, traffic_override={"pool_chunks": 2})
    cell.traffic["batch"] = max(2, cell.traffic["batch"] // 3)
    ok, rows = compare.held(control.control_numbers(cell, 2**31 + 4, card), cell.limits)
    assert not ok, rows
