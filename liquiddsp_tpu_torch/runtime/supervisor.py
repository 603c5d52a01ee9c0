"""Process-level fault tolerance: heartbeat supervision + worker restart.

Counterpart of ``liquiddsp_tpu/runtime/supervisor.py``. The reference's
failure handling is signal-level only (header/payload CRC validity feeding
the engine); the process level, a crashed or hung receiver, is left to
whoever launches the GR flowgraph. This module supplies it for a
multi-worker deployment (one worker per channel group):

- ``Heartbeat``: worker-side liveness beacon, an atomically-replaced file
  carrying (sequence, wall time). File-based rather than socket-based so a
  hung worker (stuck in an uninterruptible device call) is detected by
  STALENESS, which a kernel-buffered socket cannot show.
- ``Supervisor``: spawns worker subprocesses, polls liveness (process exit
  OR stale heartbeat), kills hung workers and respawns them with the same
  argv, bounded by ``max_restarts`` with exponential backoff. Workers resume
  from their own checkpoint at startup.
- ``save_stream_state`` / ``load_stream_state``: the StreamingRx carry and
  absolute stream position as one atomic npz (``carry_re``, ``carry_im``,
  ``samples_consumed``, ``extra_*``): the JAX package's format, so a
  checkpoint written by either package loads in the other, and a restarted
  worker continues with exactly-once frame accounting.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import time

import numpy as np
import torch


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------


class Heartbeat:
    """Worker-side liveness beacon (atomic file replace per beat)."""

    def __init__(self, path: str):
        self.path = path
        self.seq = 0

    def beat(self) -> None:
        self.seq += 1
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(f"{self.seq} {time.time()}\n")
        os.replace(tmp, self.path)  # atomic on POSIX


def save_stream_state(path: str, rx, **extra) -> None:
    """Checkpoint a StreamingRx: absolute position + overlap carry, plus any
    caller state (``extra`` numpy-convertible arrays) in the SAME atomic
    npz — a crash can never observe the stream position and the caller's
    tally out of sync (a two-file protocol would re-run or skip a chunk
    on a crash between the writes, losing or double-counting a
    boundary-straddling frame). The carry is stored as float32 real and
    imaginary planes, the JAX package's format."""
    carry = rx._carry.detach().cpu().numpy()
    cr = np.ascontiguousarray(carry.real, dtype=np.float32)
    ci = np.ascontiguousarray(carry.imag, dtype=np.float32)
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    with open(tmp, "wb") as fh:
        np.savez(fh, carry_re=cr, carry_im=ci,
                 samples_consumed=np.int64(rx._samples_consumed),
                 **{f"extra_{k}": np.asarray(v) for k, v in extra.items()})
    os.replace(tmp, path)


def load_stream_state(path: str, rx) -> dict | None:
    """Restore a checkpoint written by save_stream_state; returns the dict
    of ``extra`` arrays saved alongside (empty if none), or None when no
    checkpoint exists (fresh start). The carry is written into the
    receiver's window buffer on ``rx.device``."""
    if not os.path.exists(path):
        return None
    d = np.load(path)
    carry = (d["carry_re"] + 1j * d["carry_im"]).astype(np.complex64)
    if carry.shape != tuple(rx._carry.shape):
        raise ValueError(f"checkpoint carry {carry.shape} does not fit the receiver's {tuple(rx._carry.shape)}")
    rx._carry = torch.from_numpy(carry)
    rx._samples_consumed = int(d["samples_consumed"])
    return {k[len("extra_"):]: d[k] for k in d.files if k.startswith("extra_")}


# ---------------------------------------------------------------------------
# supervisor side
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WorkerSpec:
    """One supervised worker: argv is respawned verbatim after a failure."""

    name: str
    argv: list[str]
    heartbeat_path: str
    stale_after_s: float = 10.0  # no beat for this long => hung => restart
    max_restarts: int = 3
    backoff_s: float = 0.5  # doubled per restart


@dataclasses.dataclass
class _WorkerState:
    spec: WorkerSpec
    proc: subprocess.Popen | None = None
    restarts: int = 0
    started_at: float = 0.0
    gave_up: bool = False
    respawn_after: float = 0.0  # backoff deadline (0 = no respawn pending)
    respawn_reason: str = ""


class Supervisor:
    """Spawn + monitor + restart a set of worker processes.

    Liveness = process alive AND heartbeat fresh. A dead process is
    respawned; a stale one is SIGKILLed first (a hang in an
    uninterruptible device call — SIGTERM would not be delivered).
    ``on_event(name, event, detail)`` receives "start"/"exit"/"stale"/
    "restart"/"giveup" notifications.
    """

    def __init__(self, workers: list[WorkerSpec], on_event=None, env=None):
        self._states = [_WorkerState(spec=w) for w in workers]
        self._on_event = on_event or (lambda *a: None)
        self._env = env

    def _spawn(self, st: _WorkerState) -> None:
        st.proc = subprocess.Popen(st.spec.argv, env=self._env)
        st.started_at = time.time()
        self._on_event(st.spec.name, "start", st.proc.pid)

    def start(self) -> None:
        for st in self._states:
            self._spawn(st)

    def _heartbeat_age(self, st: _WorkerState) -> float | None:
        """Seconds since the last sign of life FROM THIS INCARNATION: a
        heartbeat file left by a killed predecessor must not count against
        (or for) the restarted worker, so the spawn time floors the clock —
        every incarnation gets a full stale_after_s grace period."""
        try:
            last = os.path.getmtime(st.spec.heartbeat_path)
        except OSError:
            last = st.started_at  # no beat yet (covers startup hangs too)
        return time.time() - max(last, st.started_at)

    def poll(self) -> None:
        """One supervision pass: restart dead/hung workers (bounded).

        Non-blocking: a failed worker's restart backoff is a per-worker
        deadline (``respawn_after``), never a sleep — a crash-looping
        worker must not delay stale-heartbeat detection of its siblings."""
        now = time.time()
        for st in self._states:
            if st.gave_up:
                continue
            if st.respawn_after:
                if now >= st.respawn_after:
                    st.respawn_after = 0.0
                    st.restarts += 1
                    self._on_event(st.spec.name, "restart", st.respawn_reason)
                    self._spawn(st)
                continue
            if st.proc is None:
                continue
            rc = st.proc.poll()
            reason = None
            if rc is not None:
                if rc == 0:
                    continue  # clean exit: done, not a failure
                reason = f"exit rc={rc}"
                self._on_event(st.spec.name, "exit", rc)
            else:
                age = self._heartbeat_age(st)
                if age is not None and age > st.spec.stale_after_s:
                    reason = f"stale heartbeat ({age:.1f}s)"
                    self._on_event(st.spec.name, "stale", age)
                    try:
                        st.proc.send_signal(signal.SIGKILL)
                        st.proc.wait(timeout=10)
                    except Exception:  # noqa: BLE001
                        pass
            if reason is None:
                continue
            if st.restarts >= st.spec.max_restarts:
                st.gave_up = True
                self._on_event(st.spec.name, "giveup", reason)
                continue
            st.respawn_reason = reason
            st.respawn_after = now + st.spec.backoff_s * (2**st.restarts)

    def run(self, poll_interval_s: float = 0.25, timeout_s: float | None = None):
        """Supervise until every worker has exited cleanly (or been given
        up on); returns the per-worker summary dicts."""
        t0 = time.time()
        while True:
            self.poll()
            live = [
                st for st in self._states
                if not st.gave_up and st.proc is not None
                and st.proc.poll() is None
            ]
            pending = [
                st for st in self._states
                if not st.gave_up and (st.proc is None or st.proc.poll() != 0)
            ]
            if not live and not pending:
                break
            if not live and pending:
                # all remaining failed processes get handled next poll
                pass
            if timeout_s is not None and time.time() - t0 > timeout_s:
                self.shutdown()
                raise TimeoutError("supervision timed out")
            time.sleep(poll_interval_s)
        return self.summary()

    def shutdown(self) -> None:
        for st in self._states:
            if st.proc is not None and st.proc.poll() is None:
                st.proc.send_signal(signal.SIGKILL)
                try:
                    st.proc.wait(timeout=10)
                except Exception:  # noqa: BLE001
                    pass

    def summary(self) -> list[dict]:
        return [
            {
                "name": st.spec.name,
                "restarts": st.restarts,
                "gave_up": st.gave_up,
                "returncode": None if st.proc is None else st.proc.poll(),
            }
            for st in self._states
        ]
