"""Closed-loop adaptation demo: TX -> channel -> RX -> cognitive engine -> TX.

Counterpart of ``apps/adaptation_demo.py`` on this package (BASELINE config
4): per-frame modulation/FEC switching at a fixed SNR or under the
reference's dynamic-noise schedule (python/cognitive_engine.py:151-167). A
packet is framegen of the commanded config, AWGN from the numpy generator,
``FlexRx.work`` and ``CognitiveEngineBlock.handler``. It runs on the GPU,
and on the CPU with ``--cpu``:

    python -m liquiddsp_tpu_torch.apps.adaptation_demo [--cpu] --ce gittins --packets 200 --snr 18

``main`` returns every packet's feedback to the engine and the engine's
decision, so that a test can replay them into another engine.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from liquiddsp_tpu_torch.core.config import FrameConfig
from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.engine.cognitive_engine import CognitiveEngineBlock
from liquiddsp_tpu_torch.phy import framegen
from liquiddsp_tpu_torch.runtime.blocks import FlexRx


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ce", default="epsilon_greedy",
                    choices=["epsilon_greedy", "annealing_epsilon_greedy",
                             "gittins", "RoTA", "meta"])
    ap.add_argument("--packets", type=int, default=100)
    ap.add_argument("--snr", type=float, default=18.0)
    ap.add_argument("--dynamic", action="store_true",
                    help="use the reference's dynamic-noise schedule")
    ap.add_argument("--payload-len", type=int, default=32)
    ap.add_argument("--kindicator", default="off", choices=["off", "on"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    ce = CognitiveEngineBlock(
        ce_type=args.ce, kindicator=args.kindicator,
        channel="nonstationary" if args.dynamic else "stationary",
        seed=args.seed,
    )
    rx = FlexRx(max_payload_len=args.payload_len, device=dev)
    rng = np.random.default_rng(args.seed)

    cfg_dict = {"modulation": 1, "inner_code": 0, "outer_code": 0}
    goodputs, feedback, decisions = [], [], []
    for pkt in range(args.packets):
        cfg = FrameConfig(cfg_dict["modulation"], cfg_dict["inner_code"],
                          cfg_dict["outer_code"], args.payload_len)
        payload = rng.integers(0, 256, (1, args.payload_len), dtype=np.uint8)
        frame = framegen.framegen(torch.from_numpy(payload), cfg, device=dev).cpu().numpy()
        t = frame.shape[1] + 1024
        x = np.zeros((1, t), dtype=np.complex64)
        x[0, 512 : 512 + frame.shape[1]] = frame
        if args.dynamic:
            noise_amp = ce.get_number()
            snr_db = 10 * np.log10((0.05 / (2 * noise_amp)) ** 2)
        else:
            snr_db = args.snr
        p_sig = np.mean(np.abs(frame) ** 2)
        sigma = np.sqrt(p_sig / (2 * 10 ** (snr_db / 10)))
        x = (x + sigma * (rng.standard_normal(x.shape)
                          + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
        infos = rx.work(x)
        if infos:
            info = infos[0]
            ok = info["payload_valid"] and np.array_equal(np.asarray(info["payload"]), payload[0])
            packet_info = {
                "header_valid": 1, "payload_valid": int(ok),
                "modulation": info["modulation"],
                "inner_code": info["inner_code"],
                "outer_code": info["outer_code"],
            }
        else:  # frame lost entirely: report failure on the chosen config
            packet_info = {"header_valid": 0, "payload_valid": 0, **cfg_dict}
        new_cfg = ce.handler(packet_info)
        feedback.append(packet_info)
        decisions.append(new_cfg)
        if new_cfg:
            cfg_dict = new_cfg
        goodputs.append(ce.store.rx_log[-1].throughput)
        if (pkt + 1) % 25 == 0:
            print(f"pkt {pkt + 1:4d}: snr={snr_db:5.1f} dB  "
                  f"avg goodput(25)={np.mean(goodputs[-25:]):.3f} bit/sym  "
                  f"config={cfg_dict}")

    print(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    print(f"\nfinal avg goodput (last 50): {np.mean(goodputs[-50:]):.3f} bit/sym")
    ki = ce.store.ki_log
    if ki:
        print(f"knowledge indicators (last): LBI={ki[-1][1]:.3f} RBI={ki[-1][2]:.3f} "
              f"CCI={ki[-1][3]:.3f} CI={ki[-1][4]:.3f}")
    return {"feedback": feedback, "decisions": decisions, "goodput": goodputs}


if __name__ == "__main__":
    main()
