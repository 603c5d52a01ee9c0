"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use they are
compiled with ``nvcc`` for ``sm_90a`` (one compile per source, all started
together), linked into one shared library under ``_build/`` and loaded with
``ctypes``. Nothing is built when a module is imported, and nothing gives way
to a plain PyTorch version when a build or a launch fails: it raises.

Each C entry point launches on the stream it is handed, does not synchronise,
allocates nothing and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("correlator.cu", "extract.cu", "recover.cu", "viterbi.cu", "halo.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches per kernel since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else
LAUNCHES: dict[str, int] = {
    "correlator": 0, "extract": 0, "recover": 0, "viterbi": 0, "halo": 0, "halo_wait": 0,
}

_vp, _i, _f, _ll, _ull = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong,
                          ctypes.c_ulonglong)
_ARGTYPES = {
    # x, templates, split template fragments, rho2, fbin, corr, energy, B, T,
    # inv_es, stream
    "lq_correlate_reduced": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _f, _vp],
    # x, starts, wr, wi, B, T, K, n, stream
    "lq_extract_windows": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _vp],
    # wr, wi, dphi, phi, gamma, taps, y, stamps or NULL, B*K, n, n_syms, tile, stream
    "lq_recover_symbols": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _vp],
    # lam, warp signs, dec, bits, stamps or NULL, B, steps, dec row stride, stream
    "lq_viterbi": [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _vp],
    # x, windows, left rank's windows or NULL, B, n_time, T_local, ov, row stride,
    # zero_last, stream
    "lq_halo_windows": [_vp, _vp, _vp, _i, _i, _i, _i, _ll, _i, _vp],
    # the same, then the flag signal set to value; count, stream
    "lq_halo_windows_signal": [_vp, _vp, _vp, _i, _i, _i, _i, _ll, _i, _vp, _ull, _vp, _vp],
    # flag to set or NULL, its value, flag to wait on or NULL, its value, stream
    "lq_halo_order": [_vp, _ull, _vp, _ull, _vp],
}

_lib: ctypes.CDLL | None = None
build_log: list[str] = []  # compiler output of the library's build, one entry per source


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def toolkit_exe(name: str) -> str:
    """Path of a program of the CUDA toolkit (``nvcc``, ``cuobjdump``)."""
    exe = shutil.which(name)
    if exe is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
        if not cand.exists():
            raise RuntimeError(f"{name} not found: the CUDA kernels cannot be built")
        exe = str(cand)
    return exe


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/libliquiddsp_kernels_<hash>.so``
    and return its path. A library whose name carries the hash of the current
    sources is reused. The compiler's output (registers, shared memory and
    spills of each kernel) is kept in ``build_log`` and in a ``.log`` file
    beside the library, from which a later process that reuses the library
    fills ``build_log``.

    Several processes may build at once (the ranks of a distributed run on a
    fresh tree): each compiles its objects into a directory of its own and
    links into a file of its own, and the library appears under its final
    name by one atomic rename, so every process loads a whole library."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    lib_path = BUILD_DIR / f"libliquiddsp_kernels_{h.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists() and log_path.exists():
        build_log[:] = json.loads(log_path.read_text())
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = toolkit_exe("nvcc")
    obj_dir = Path(tempfile.mkdtemp(prefix=f"obj.{os.getpid()}.", dir=BUILD_DIR))
    try:
        _compile_and_link(nvcc, obj_dir, lib_path, log_path)
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    return lib_path


def _compile_and_link(nvcc: str, obj_dir: Path, lib_path: Path, log_path: Path) -> None:
    procs = []
    for name in SOURCES:
        obj = obj_dir / (name + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, failed = [], []
    build_log.clear()
    for name, obj, p in procs:
        out, _ = p.communicate()
        build_log.append(f"== {name}\n{out}")
        if p.returncode != 0:
            failed.append(f"nvcc failed on {name}:\n{out}")
        objs.append(str(obj))
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = obj_dir / lib_path.name
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    log_tmp = obj_dir / log_path.name
    log_tmp.write_text(json.dumps(build_log))
    # the log before the library: whoever finds the one finds the other
    os.replace(log_tmp, log_path)
    os.replace(tmp, lib_path)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        for fn, argtypes in _ARGTYPES.items():
            getattr(loaded, fn).argtypes = argtypes
            getattr(loaded, fn).restype = ctypes.c_int
        _lib = loaded
    return _lib


def launch(kernel: str, fn: str, device: torch.device, *args) -> None:
    """Call C entry point ``fn`` on PyTorch's current stream of ``device``,
    raise on a refused launch, and count one launch of ``kernel``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib(), fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error code {rc}")
    LAUNCHES[kernel] += 1


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
