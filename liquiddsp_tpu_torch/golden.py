"""ctypes bindings to the native golden oracle (golden/golden.cpp).

Counterpart of ``liquiddsp_tpu/golden.py``, this package's own binding of the
same library. The golden library is an independent scalar C++ implementation
of every codec/DSP primitive (msequence, preamble, CRC-24/16, RRC taps,
constellations, block codes, the convolutional code and its Viterbi decoder,
Reed-Solomon), the bit-exactness oracle of the batched ops.

At first use it compiles ``golden/golden.cpp`` with ``g++`` into
``liquiddsp_tpu_torch/_build/libgolden.so`` (again when the source is newer
than the library), under a file lock so that concurrent processes never load
a half-written library. A failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import pathlib
import subprocess

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _ROOT / "golden" / "golden.cpp"
_LIB_PATH = pathlib.Path(__file__).resolve().parent / "_build" / "libgolden.so"

_U8 = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")


def _find_or_build() -> str:
    """The library's path, compiled first if it is missing or older than the
    source."""
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(_LIB_PATH.parent / ".golden.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SOURCE.stat().st_mtime:
                tmp = _LIB_PATH.with_suffix(".so.tmp")
                out = subprocess.run(
                    ["g++", "-std=c++17", "-O2", "-fPIC", "-Wall", "-shared", "-o", str(tmp),
                     str(_SOURCE)], capture_output=True, text=True)
                if out.returncode != 0:
                    raise RuntimeError(f"building the golden library failed:\n{out.stderr}")
                tmp.replace(_LIB_PATH)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return str(_LIB_PATH)


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    so = ctypes.CDLL(_find_or_build())
    so.golden_msequence.restype = None
    so.golden_msequence.argtypes = [ctypes.c_uint] * 4 + [_U8]
    so.golden_preamble.restype = None
    so.golden_preamble.argtypes = [_F32, _F32, ctypes.c_uint]
    so.golden_crc24.restype = ctypes.c_uint32
    so.golden_crc24.argtypes = [_U8, ctypes.c_uint]
    so.golden_crc16.restype = ctypes.c_uint32
    so.golden_crc16.argtypes = [_U8, ctypes.c_uint]
    so.golden_rrc_taps.restype = None
    so.golden_rrc_taps.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_double,
                                   ctypes.c_double, _F32]
    so.golden_constellation.restype = ctypes.c_int
    so.golden_constellation.argtypes = [ctypes.c_uint, _F32, _F32]
    so.golden_block_encode.restype = ctypes.c_int
    so.golden_block_encode.argtypes = [ctypes.c_uint, _U8, ctypes.c_uint, _U8]
    so.golden_block_decode.restype = ctypes.c_int
    so.golden_block_decode.argtypes = [ctypes.c_uint, _U8, ctypes.c_uint, _U8]
    so.golden_conv_encode.restype = ctypes.c_int
    so.golden_conv_encode.argtypes = [ctypes.c_uint, _U8, ctypes.c_uint, _U8]
    so.golden_viterbi_decode.restype = ctypes.c_int
    so.golden_viterbi_decode.argtypes = [ctypes.c_uint, _U8, ctypes.c_uint,
                                         ctypes.c_uint, _U8]
    so.golden_rs_encode_block.restype = None
    so.golden_rs_encode_block.argtypes = [_U8, ctypes.c_uint, _U8]
    so.golden_rs_decode_block.restype = ctypes.c_int
    so.golden_rs_decode_block.argtypes = [_U8, ctypes.c_uint, _U8]
    return so


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def msequence(m: int, g: int, a: int, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.uint8)
    lib().golden_msequence(m, g, a, n, out)
    return out


def preamble(n: int = 64) -> np.ndarray:
    re = np.zeros(n, dtype=np.float32)
    im = np.zeros(n, dtype=np.float32)
    lib().golden_preamble(re, im, n)
    return (re + 1j * im).astype(np.complex64)


def crc24(data: bytes | np.ndarray) -> int:
    arr = np.frombuffer(bytes(data), dtype=np.uint8).copy()
    return int(lib().golden_crc24(arr, len(arr)))


def crc16(data: bytes | np.ndarray) -> int:
    arr = np.frombuffer(bytes(data), dtype=np.uint8).copy()
    return int(lib().golden_crc16(arr, len(arr)))


def rrc_taps(k: int = 2, m: int = 7, beta: float = 0.3, dt: float = 0.0) -> np.ndarray:
    out = np.zeros(2 * k * m + 1, dtype=np.float32)
    lib().golden_rrc_taps(k, m, beta, dt, out)
    return out


def constellation(mod: int) -> np.ndarray:
    re = np.zeros(64, dtype=np.float32)
    im = np.zeros(64, dtype=np.float32)
    m = lib().golden_constellation(mod, re, im)
    if m <= 0:
        raise ValueError(f"golden: no constellation for modulation {mod}")
    return (re[:m] + 1j * im[:m]).astype(np.complex64)


def block_encode(outer: int, bits: np.ndarray, k: int) -> np.ndarray:
    nblocks = len(bits) // k
    out = np.zeros(nblocks * 128, dtype=np.uint8)
    n = lib().golden_block_encode(outer, _u8(bits), nblocks, out)
    if n <= 0:
        raise ValueError(f"golden: no block code for outer code {outer}")
    return out[: nblocks * n]


def block_decode(outer: int, coded: np.ndarray, n: int) -> np.ndarray:
    nblocks = len(coded) // n
    out = np.zeros(nblocks * 64, dtype=np.uint8)
    k = lib().golden_block_decode(outer, _u8(coded), nblocks, out)
    if k <= 0:
        raise ValueError(f"golden: no block code for outer code {outer}")
    return out[: nblocks * k]


def conv_encode(inner: int, bits: np.ndarray) -> np.ndarray:
    out = np.zeros(2 * (len(bits) + 6) + 16, dtype=np.uint8)
    n = lib().golden_conv_encode(inner, _u8(bits), len(bits), out)
    return out[:n]


def viterbi_decode(inner: int, coded: np.ndarray, nbits: int) -> np.ndarray:
    out = np.zeros(nbits, dtype=np.uint8)
    lib().golden_viterbi_decode(inner, _u8(coded), len(coded), nbits, out)
    return out


def rs_encode_block(msg: np.ndarray) -> np.ndarray:
    out = np.zeros(len(msg) + 32, dtype=np.uint8)
    lib().golden_rs_encode_block(_u8(msg), len(msg), out)
    return out


def rs_decode_block(code: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros(k, dtype=np.uint8)
    lib().golden_rs_decode_block(_u8(code), k, out)
    return out
