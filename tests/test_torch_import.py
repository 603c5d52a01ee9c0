"""The PyTorch port imports without jax, and never carries on on the CPU
when it finds no GPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import liquiddsp_tpu_torch
import liquiddsp_tpu_torch.phy.framegen, liquiddsp_tpu_torch.phy.framesync
import liquiddsp_tpu_torch.phy.detector, liquiddsp_tpu_torch.phy.tables
import liquiddsp_tpu_torch.kernels.correlator, liquiddsp_tpu_torch.kernels.extract
import liquiddsp_tpu_torch.kernels.recover, liquiddsp_tpu_torch.kernels.viterbi
import liquiddsp_tpu_torch.profile_step
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "liquiddsp_tpu" or m.startswith("liquiddsp_tpu.")]
print("LEAKED", bad)
"""


def test_import_leaves_jax_and_reference_package_out():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_no_source_file_imports_jax_or_reference_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|liquiddsp_tpu)(\.|\s|$)", re.M)
    files = list((REPO / "liquiddsp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: device=None is allowed to run")


@pytest.mark.parametrize("entry", ["framegen", "detect", "framesync_fixed", "phy_tables"])
def test_entry_points_raise_without_gpu(entry):
    """device=None means the GPU; without one the call raises instead of
    running on the CPU."""
    _no_gpu()
    from liquiddsp_tpu_torch import FrameConfig
    from liquiddsp_tpu_torch.phy import detector, framegen, framesync, tables

    cfg = FrameConfig(1, 0, 0, 64)
    x = torch.zeros((1, 2048), dtype=torch.complex64)
    calls = {
        "framegen": lambda: framegen.framegen(torch.zeros((1, 64), dtype=torch.uint8), cfg),
        "detect": lambda: detector.detect(x, 2),
        "framesync_fixed": lambda: framesync.framesync_fixed(x, cfg, 2),
        "phy_tables": lambda: tables.phy_tables(cfg),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_chip_smoke_fails_without_gpu():
    _no_gpu()
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_unported_paths_raise_not_implemented():
    from liquiddsp_tpu_torch import FrameConfig
    from liquiddsp_tpu_torch.ops import modem
    from liquiddsp_tpu_torch.ops.fec import registry
    from liquiddsp_tpu_torch.phy import framegen

    with pytest.raises(NotImplementedError):
        modem.modulate(torch.zeros(4, dtype=torch.int32), 4)  # DPSK2
    with pytest.raises(NotImplementedError):
        registry.outer_encode(torch.zeros((1, 8), dtype=torch.uint8), 2)  # RS
    with pytest.raises(NotImplementedError):
        registry.outer_decode(torch.zeros((1, 14), dtype=torch.int8), 1, 3)  # Hamming(7,4)
    with pytest.raises(NotImplementedError):
        framegen.framegen(np.zeros((1, 64), np.uint8), FrameConfig(4, 0, 0, 64), device="cpu")
