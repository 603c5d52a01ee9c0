"""Block-level API: flex_tx / flex_rx / frame_detector_cc parity.

Counterpart of ``liquiddsp_tpu/runtime/blocks.py``. The reference exposes
three GR blocks (include/liquiddsp/flex_tx.h:36-53, flex_rx.h:37-51,
frame_detector_cc.h:36-50) wired through message ports:

- ``FlexTx``: payload PDUs in -> modulated c64 frame PDUs out; runtime
  reconfigurable via ``configure({modulation, inner_code, outer_code})``
  dict messages (lib/flex_tx_impl.cc:183-189) and the setters. Out-of-range
  indices fall back to defaults with a warning, as the reference's switch
  defaults do (flex_tx_impl.cc:111-114, 140-145, 176-179).
- ``FlexRx``: complex stream in -> ``constellation`` / ``payload_data`` /
  ``packet_info`` ports out (lib/flex_rx_impl.cc:61-63, 217-247). No config
  parameters: frames are self-describing; the payload modem and codes come
  from each decoded header (flex_rx.h:50). The front end (``sync_common``)
  runs once per block for every frame; the payloads are decoded in groups of
  one header config each (``decode_payload_symbols``).
- ``FrameDetectorCC``: passthrough + detection count
  (lib/frame_detector_cc_impl.cc:66-97).

Every block runs on ``device`` (``None``: the GPU). The device work of a
call is a program (``core.program``), cached as the JAX package caches its
jits and replayed as a CUDA graph on a card: the transmitter per (config,
batch), the receiver's front end per (B, T, n_syms, max_frames, threshold),
a payload group per (config, n_flat, n_take) and the detector per shape.
What the host does between programs stays on the host: the fetch of the
packed plane, the grouping by header config and the speculative decode.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from liquiddsp_tpu_torch.core.config import (
    NUM_INNER_CODES,
    NUM_MODULATIONS,
    NUM_OUTER_CODES,
    FrameConfig,
)
from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.core.program import Program
from liquiddsp_tpu_torch.phy import detector, framegen, framesync
from liquiddsp_tpu_torch.phy import frame_spec as fs
from liquiddsp_tpu_torch.phy.tables import phy_tables
from liquiddsp_tpu_torch.runtime.bus import PDU, MessageBus


def _as_batch(x, device: torch.device) -> torch.Tensor:
    """[B, T] (or [T]) samples of any array type -> complex64 [B, T] on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    x = x.to(device=device, dtype=torch.complex64)
    return (x[None] if x.dim() == 1 else x).contiguous()


def _tx_body(key: tuple):
    """FlexTx's program: [batch, payload_len] payloads -> frames."""
    m, i, o, payload_len, _, dev = key
    cfg = FrameConfig(m, i, o, payload_len)
    return lambda payload: framegen.framegen(payload, cfg, device=dev)


def _sync_body(key: tuple):
    """FlexRx's front end: ``sync_common`` plus every per-slot scalar the
    host needs as ONE packed [10, B, K] float32 plane."""
    _, _, n_syms, max_frames, threshold, dev = key
    tables = phy_tables(None, dev)

    def run(x):
        det, syms, (hdr_valid, _, plen, mod, inner, outer), evm_lin = framesync.sync_common(
            x, n_syms, max_frames, threshold, tables=tables, device=dev)
        packed = torch.stack([
            det.mask.to(torch.float32), hdr_valid.to(torch.float32), plen.to(torch.float32),
            mod.to(torch.float32), inner.to(torch.float32), outer.to(torch.float32),
            evm_lin, det.gamma, det.dphi, det.start.to(torch.float32),
        ])
        return syms, evm_lin, packed

    return run


def _payload_body(key: tuple):
    """A payload group: gather the slots ``idx`` out of the flattened [B*K,
    n_syms] symbol buffer and decode them as ``cfg``: uint8 [n_take, width],
    the payload bytes first and the CRC pass flag in the last column."""
    cfg, _, n_take, width, dev = key
    tables = phy_tables(cfg, dev)

    def run(syms_flat, evm_flat, idx):
        payloads, crc_ok = framesync.decode_payload_symbols(
            syms_flat[idx], cfg, noise_var=evm_flat[idx], tables=tables)
        gap = torch.zeros((n_take, width - 1 - cfg.payload_len), dtype=torch.uint8, device=dev)
        return torch.cat([payloads, gap, crc_ok[:, None].to(torch.uint8)], dim=-1)

    return run


def _detector_body(key: tuple):
    """FrameDetectorCC's program: [B, T] -> (detections a row, detections)."""
    _, _, max_frames, threshold, dev = key

    def run(x):
        _, count, det = detector.frame_detector_cc(x, max_frames, threshold, device=dev)
        return count, det

    return run


# the programs, keyed as the JAX package keys its cached jits (plus the device)
_TX = Program("FlexTx", _tx_body)
_SYNC = Program("FlexRx front end", _sync_body)
_PAYLOAD = Program("FlexRx payload group", _payload_body)
_DETECT = Program("FrameDetectorCC", _detector_body)


def _decode_group(cfg: FrameConfig, syms_flat: torch.Tensor, evm_flat: torch.Tensor,
                  flat_idx: list[int], width: int) -> torch.Tensor:
    """Decode the slots ``flat_idx`` of the flattened [B*K, n_syms] symbol
    buffer as ``cfg`` through their program: uint8 [G, width], the payload
    bytes first and the CRC pass flag in the last column."""
    dev = syms_flat.device
    idx = torch.tensor(flat_idx, dtype=torch.int64)  # on the host: a graph copies it in
    key = (cfg, syms_flat.shape[0], len(flat_idx), width, dev)
    return _PAYLOAD(key, syms_flat, evm_flat, idx, device=dev)


class FlexTx:
    """Packet transmitter block (flex_tx parity)."""

    def __init__(
        self,
        modulation: int = 0,
        inner_code: int = 0,
        outer_code: int = 0,
        bus: MessageBus | None = None,
        *,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device)
        self.bus = bus or MessageBus()
        self.set_modulation(modulation)
        self.set_inner_code(inner_code)
        self.set_outer_code(outer_code)
        self.header_user = None  # 14 zero bytes by default
        self.num_frames = 0  # d_num_frames (lib/flex_tx_impl.cc:49)
        self.bus.subscribe("pdus_in", self.send_pkt)
        self.bus.subscribe("configuration", self.configure)

    def set_modulation(self, modulation: int):
        if not 0 <= int(modulation) < NUM_MODULATIONS:
            warnings.warn("Unsupported Modulation Defaulting to BPSK.")
            modulation = 0
        self.modulation = int(modulation)

    def set_inner_code(self, inner_code: int):
        if not 0 <= int(inner_code) < NUM_INNER_CODES:
            warnings.warn("Unsupported FEC Defaulting to none.")
            inner_code = 0
        self.inner_code = int(inner_code)

    def set_outer_code(self, outer_code: int):
        if not 0 <= int(outer_code) < NUM_OUTER_CODES:
            warnings.warn("Unsupported FEC Defaulting to none.")
            outer_code = 0
        self.outer_code = int(outer_code)

    def configure(self, configuration: dict):
        """Config dict message handler (lib/flex_tx_impl.cc:183-189)."""
        if "modulation" in configuration:
            self.set_modulation(configuration["modulation"])
        if "inner_code" in configuration:
            self.set_inner_code(configuration["inner_code"])
        if "outer_code" in configuration:
            self.set_outer_code(configuration["outer_code"])

    def send_pkt(self, pdu) -> PDU:
        """Assemble + modulate one (or a batch of) payloads; publish the
        frame PDU [B, frame_samples] on ``pdus`` (lib/flex_tx_impl.cc:191-209)."""
        payload = pdu.data if isinstance(pdu, PDU) else pdu
        payload = torch.as_tensor(payload, dtype=torch.uint8).to(self.device)
        if payload.dim() == 1:
            payload = payload[None]
        key = (self.modulation, self.inner_code, self.outer_code, payload.shape[-1],
               payload.shape[0], self.device)
        frames = _TX(key, payload, device=self.device)
        out = PDU(
            meta={
                "modulation": self.modulation,
                "inner_code": self.inner_code,
                "outer_code": self.outer_code,
            },
            data=frames,
        )
        self.bus.publish("pdus", out)
        self.num_frames += payload.shape[0]
        return out


class FlexRx:
    """Packet receiver block (flex_rx parity): self-describing frames, one
    front end per block, payloads decoded in groups of one header config."""

    def __init__(
        self,
        max_payload_len: int = 64,
        max_frames_per_block: int = 8,
        threshold: float = 0.45,
        bus: MessageBus | None = None,
        *,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device)
        self.bus = bus or MessageBus()
        self.max_payload_len = max_payload_len
        self.max_frames = max_frames_per_block
        self.threshold = threshold
        # symbol buffer sized for the longest config at max payload
        self.n_syms = fs.max_frame_spec(max_payload_len).frame_syms
        self.tables = phy_tables(None, self.device)
        self.num_packets = 0
        self.bus.subscribe("stream_in", self.work)

    def work(self, x) -> list[dict]:
        """Process a [B, T] (or [T]) sample block; publish constellation /
        payload_data / packet_info per decoded frame (lib/flex_rx_impl.cc:
        203-253). Returns the list of packet_info dicts, sorted by (batch,
        start)."""
        return self.work_complete(self.work_submit(x))

    def work_submit(self, x, expected_configs=None):
        """Queue the front end of a block on the device WITHOUT waiting and
        return an opaque handle for :meth:`work_complete`.

        ``expected_configs``: optional per-channel [(mod, inner, outer,
        payload_len), ...], the configs the caller commanded (a closed-loop
        TX knows them). Then the payload decode of detection slot 0 of each
        channel is queued SPECULATIVELY now, behind the copy of the per-slot
        header plane to the host, so it runs while the host waits for that
        copy. work_complete uses a speculative row only where the decoded
        header confirms the commanded config; any other slot takes the
        grouped decode."""
        dev = self.device
        x = _as_batch(x, dev)
        key = (x.shape[0], x.shape[1], self.n_syms, self.max_frames, self.threshold, dev)
        syms, evm_lin, packed = _SYNC(key, x, device=dev)
        ready = None
        if packed.is_cuda:  # into pinned host memory, behind an event
            packed = packed.to("cpu", non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        k = self.max_frames
        syms_flat = syms.reshape((-1,) + syms.shape[2:])
        evm_flat = evm_lin.reshape(-1)
        spec = {}
        if expected_configs is not None:
            by_cfg: dict[tuple[int, int, int, int], list[int]] = {}
            for ch, (m, i, o, pl) in enumerate(expected_configs):
                by_cfg.setdefault((int(m), int(i), int(o), int(pl)), []).append(ch)
            for key, chans in by_cfg.items():
                out = _decode_group(FrameConfig(*key), syms_flat, evm_flat,
                                    [b * k for b in chans], self.max_payload_len + 1)
                spec[key] = (chans, out)
        return syms, syms_flat, evm_flat, packed, ready, spec

    def work_complete(self, handle) -> list[dict]:
        """Finish a :meth:`work_submit` block: read the packed header plane,
        decode the payloads of each header config as one group, fetch every
        group's bytes in one copy, publish the ports, return packet_info
        dicts."""
        syms, syms_flat, evm_flat, packed, ready, spec = handle
        if ready is not None:
            ready.synchronize()
        P = packed.numpy()  # [10, B, K]: the block's only read of the front end
        mask = P[0] > 0.5
        hdr_valid = P[1] > 0.5
        plen_h = P[2].astype(np.int64)
        mod_h = P[3].astype(np.int64)
        inner_h = P[4].astype(np.int64)
        outer_h = P[5].astype(np.int64)
        evm_h = P[6]
        rssi_h = 20.0 * np.log10(np.maximum(P[7], 1e-12))
        cfo_h = P[8]
        start_h = P[9].astype(np.int64)

        # group header-valid slots by decoded config
        groups: dict[tuple[int, int, int, int], list[tuple[int, int]]] = {}
        want_const = self.bus.has_subscribers("constellation")
        for b, k in zip(*np.nonzero(mask)):
            # constellation published regardless of validity (cc:217-221);
            # the per-slot device gather is skipped when nobody subscribes
            if want_const:
                self.bus.publish("constellation", PDU(meta={}, data=syms[b, k]))
            if not hdr_valid[b, k]:
                continue
            m, i, o, pl = (
                int(mod_h[b, k]), int(inner_h[b, k]),
                int(outer_h[b, k]), int(plen_h[b, k]),
            )
            if not (
                0 <= m < NUM_MODULATIONS
                and 0 <= i < NUM_INNER_CODES
                and 0 <= o < NUM_OUTER_CODES
                and 0 < pl <= self.max_payload_len
            ):
                continue
            groups.setdefault((m, i, o, pl), []).append((int(b), int(k)))

        K = mask.shape[1]
        # queue EVERY group's decode before reading any result; slots whose
        # decode was queued speculatively (header config == commanded config,
        # slot 0) reuse that row: the same inputs through the same code
        parts, n_rows, row_of, spec_rows = [], 0, {}, {}
        for key, (chans, out) in spec.items():
            spec_rows[key] = {b: n_rows + j for j, b in enumerate(chans)}
            parts.append(out)
            n_rows += out.shape[0]
        for key, slots in groups.items():
            confirmed = spec_rows.get(key, {})
            rest = []
            for b, k in slots:
                if k == 0 and b in confirmed:
                    row_of[(b, k)] = confirmed[b]
                else:
                    rest.append((b, k))
            if rest:
                parts.append(_decode_group(FrameConfig(*key), syms_flat, evm_flat,
                                           [b * K + k for b, k in rest], self.max_payload_len + 1))
                row_of.update((bk, n_rows + j) for j, bk in enumerate(rest))
                n_rows += len(rest)
        rows = torch.cat(parts).cpu().numpy() if parts else None

        infos: list[dict] = []
        for (m, i, o, pl), slots in groups.items():
            for b, k in slots:
                out_row = rows[row_of[(b, k)]]
                payload = out_row[:pl]
                payload_valid = bool(out_row[-1] != 0)
                if payload_valid:
                    self.bus.publish("payload_data", PDU(meta={}, data=payload))
                # framesyncstats_s parity: EVM/RSSI/CFO alongside the config
                # fields (lib/flex_rx_impl.cc:198, 236-247)
                info = {
                    "header_valid": 1,
                    "payload_valid": int(payload_valid),
                    "modulation": m,
                    "inner_code": i,
                    "outer_code": o,
                    "payload_len": pl,
                    "payload": payload,
                    "evm": float(10.0 * np.log10(max(evm_h[b, k], 1e-12))),
                    "rssi": float(rssi_h[b, k]),
                    "cfo": float(cfo_h[b, k]),
                    "start": int(start_h[b, k]),
                    "batch": int(b),
                }
                self.bus.publish("packet_info", info)
                infos.append(info)
                self.num_packets += 1
        # stable frame order across the batch (detection order within channel)
        infos.sort(key=lambda d: (d["batch"], d["start"]))
        return infos


class FrameDetectorCC:
    """Standalone detector block (frame_detector_cc parity): complex
    passthrough + detection counter."""

    def __init__(self, threshold: float = 0.45, max_frames: int = 16, *,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.threshold = threshold
        self.max_frames = max_frames
        self.num_frames = 0

    def work(self, x):
        x = _as_batch(x, self.device)
        key = (x.shape[0], x.shape[1], self.max_frames, self.threshold, self.device)
        count, det = _DETECT(key, x, device=self.device)
        self.num_frames += int(count.sum())
        return x, det
