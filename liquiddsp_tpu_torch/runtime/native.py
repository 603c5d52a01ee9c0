"""ctypes bindings for the native C++ streaming runtime (native/sdr_runtime.cpp).

Counterpart of ``liquiddsp_tpu/runtime/native.py``, this package's own
binding of the same library. The native layer provides, in C++, the runtime
pieces the reference leaves to the GNU Radio runtime: SPSC stream ring
buffers with overlap-carry reads, bounded message queues (the PMT-port
analog), a threaded rate-controlled sample source and atomic counters. It is
host code for ingest, not a kernel: IO threads fill the ring while the
Python thread feeds the device.

At first use it builds ``native/build/libsdrrt.so`` with ``make -C native``
(the repository's own Makefile), under a file lock so that concurrent
processes never load a half-written library.
"""

from __future__ import annotations

import ctypes as C
import fcntl
import json
import pathlib
import subprocess
import threading

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
_NATIVE_DIR = _ROOT / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libsdrrt.so"

_lib = None
_lock = threading.Lock()


def _build() -> None:
    """``make -C native`` under an exclusive lock on ``native/build/.lock``."""
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(_LIB_PATH.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True, capture_output=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        _build()
        lib = C.CDLL(str(_LIB_PATH))
        u64, i64, p = C.c_uint64, C.c_int64, C.c_void_p
        u8p = C.POINTER(C.c_uint8)
        sigs = {
            "ring_create": (p, [u64]),
            "ring_destroy": (None, [p]),
            "ring_capacity": (u64, [p]),
            "ring_readable": (u64, [p]),
            "ring_writable": (u64, [p]),
            "ring_set_eof": (None, [p]),
            "ring_eof": (C.c_int, [p]),
            "ring_write": (u64, [p, u8p, u64]),
            "ring_read_overlap": (u64, [p, u8p, u64, u64]),
            "ring_total_written": (u64, [p]),
            "ring_total_read": (u64, [p]),
            "msgq_create": (p, [u64]),
            "msgq_destroy": (None, [p]),
            "msgq_put": (C.c_int, [p, u8p, u64]),
            "msgq_get": (i64, [p, u8p, u64, i64]),
            "msgq_size": (u64, [p]),
            "msgq_dropped": (u64, [p]),
            "source_create": (p, [p, u8p, u64, u64, C.c_double, C.c_int]),
            "source_stop": (None, [p]),
            "source_destroy": (None, [p]),
            "counters_create": (p, [u64]),
            "counters_destroy": (None, [p]),
            "counters_add": (None, [p, u64, u64]),
            "counters_get": (u64, [p, u64]),
        }
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(C.POINTER(C.c_uint8))


class RingBuffer:
    """SPSC byte ring with overlap-carry reads (gr stream-buffer analog)."""

    def __init__(self, capacity_bytes: int):
        self._lib = _load()
        self._h = self._lib.ring_create(capacity_bytes)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
            self._h = None

    @property
    def capacity(self) -> int:
        return self._lib.ring_capacity(self._h)

    @property
    def readable(self) -> int:
        return self._lib.ring_readable(self._h)

    @property
    def writable(self) -> int:
        return self._lib.ring_writable(self._h)

    @property
    def eof(self) -> bool:
        return bool(self._lib.ring_eof(self._h))

    def set_eof(self):
        self._lib.ring_set_eof(self._h)

    def write(self, data: np.ndarray) -> int:
        buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        return self._lib.ring_write(self._h, _u8ptr(buf), buf.nbytes)

    def read_overlap(self, nbytes: int, overlap_bytes: int) -> np.ndarray | None:
        """Read nbytes, rewinding the read cursor by overlap_bytes (the carry
        re-read by the next chunk — the frame-straddle contract). None if
        fewer than nbytes are buffered."""
        out = np.empty(nbytes, dtype=np.uint8)
        got = self._lib.ring_read_overlap(self._h, _u8ptr(out), nbytes, overlap_bytes)
        return out if got else None

    @property
    def total_written(self) -> int:
        return self._lib.ring_total_written(self._h)

    @property
    def total_read(self) -> int:
        return self._lib.ring_total_read(self._h)


class MessageQueue:
    """Bounded MPSC queue of JSON-serializable messages (PMT-port analog)."""

    def __init__(self, max_msgs: int = 65536, max_msg_bytes: int = 1 << 20):
        self._lib = _load()
        self._h = self._lib.msgq_create(max_msgs)
        self._cap = max_msg_bytes

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.msgq_destroy(self._h)
            self._h = None

    def put(self, msg) -> bool:
        raw = np.frombuffer(json.dumps(msg).encode(), dtype=np.uint8)
        return bool(self._lib.msgq_put(self._h, _u8ptr(raw), raw.nbytes))

    def get(self, timeout_ms: int = 0):
        buf = np.empty(self._cap, dtype=np.uint8)
        n = self._lib.msgq_get(self._h, _u8ptr(buf), self._cap, timeout_ms)
        if n <= 0:
            return None
        return json.loads(bytes(buf[:n]).decode())

    def __len__(self) -> int:
        return self._lib.msgq_size(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.msgq_dropped(self._h)


class StreamSource:
    """Native producer thread feeding a ring at a target sample rate."""

    def __init__(
        self,
        ring: RingBuffer,
        samples: np.ndarray,
        rate: float = 0.0,
        repeat: bool = False,
    ):
        self._lib = _load()
        buf = np.ascontiguousarray(samples)
        raw = buf.view(np.uint8).reshape(-1)
        self._ring = ring  # keep alive
        self._h = self._lib.source_create(
            ring._h, _u8ptr(raw), raw.nbytes, buf.itemsize, rate, int(repeat)
        )

    def stop(self):
        if getattr(self, "_h", None):
            self._lib.source_stop(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.source_destroy(self._h)
            self._h = None


class Counters:
    """Named atomic counters (per-stage observability, SURVEY.md 5.1/5.5)."""

    def __init__(self, names: list[str]):
        self._lib = _load()
        self.names = list(names)
        self._h = self._lib.counters_create(len(self.names))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.counters_destroy(self._h)
            self._h = None

    def add(self, name: str, delta: int = 1):
        self._lib.counters_add(self._h, self.names.index(name), delta)

    def get(self, name: str) -> int:
        return self._lib.counters_get(self._h, self.names.index(name))

    def report(self) -> dict:
        return {n: self.get(n) for n in self.names}


class NativeChunkSource:
    """Chunked complex64 stream front-end for StreamingRx.

    A native source thread fills the ring; ``chunks()`` yields [n_chunk]
    complex64 arrays with ``overlap`` samples of carry re-read between
    consecutive chunks, until the stream is exhausted.
    """

    ITEM = 8  # complex64

    def __init__(
        self,
        samples: np.ndarray,
        chunk_len: int,
        overlap: int = 0,
        rate: float = 0.0,
        capacity_chunks: int = 8,
    ):
        assert samples.dtype == np.complex64
        self.chunk_len = chunk_len
        self.overlap = overlap
        self.ring = RingBuffer(capacity_chunks * chunk_len * self.ITEM)
        self.source = StreamSource(self.ring, samples, rate=rate)

    def chunks(self):
        import time as _time

        nbytes = self.chunk_len * self.ITEM
        ob = self.overlap * self.ITEM
        while True:
            raw = self.ring.read_overlap(nbytes, ob)
            if raw is None:
                # after EOF the readable count can only shrink; a residue
                # smaller than one chunk will never complete — stop
                if self.ring.eof and self.ring.readable < nbytes:
                    return
                # yield the core instead of busy-spinning while the source
                # thread fills the ring (rate-throttled streams otherwise
                # peg a host core for the whole run)
                _time.sleep(1e-3)
                continue
            yield raw.view(np.complex64)

    def stop(self):
        self.source.stop()
