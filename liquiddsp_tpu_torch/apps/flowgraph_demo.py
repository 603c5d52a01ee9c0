"""Run a declarative flowgraph (grc/graphs/*.yaml): the GRC runtime analog.

Counterpart of ``apps/flowgraph_demo.py`` on this package. The blocks, their
typed parameters and the message-port wiring all come from the YAML
descriptor layer (liquiddsp_tpu_torch/grc/*.yaml via grc/loader.py); this
script only steps the sources and reports. The ``adaptation_loop`` graph is
the closed loop TX -> channel -> RX -> cognitive engine -> TX. It runs on the
GPU, and on the CPU with ``--cpu``:

    python -m liquiddsp_tpu_torch.apps.flowgraph_demo [--cpu] --graph liquiddsp_tpu_torch/grc/graphs/adaptation_loop.yaml --packets 100
    python -m liquiddsp_tpu_torch.apps.flowgraph_demo [--cpu] --graph liquiddsp_tpu_torch/grc/graphs/loopback.yaml --packets 20
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from liquiddsp_tpu_torch.core.device import resolve_device
from liquiddsp_tpu_torch.grc.loader import GRAPHS_DIR, Flowgraph


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--graph", default=os.path.join(GRAPHS_DIR, "adaptation_loop.yaml"))
    ap.add_argument("--packets", type=int, default=100)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    fg = Flowgraph.load(args.graph, device=resolve_device("cpu" if args.cpu else None))
    blocks = fg.blocks
    ce, tx, rx = blocks.get("ce"), blocks.get("tx"), blocks.get("rx")

    goodputs = []
    for pkt in range(args.packets):
        n_before = ce.num_packets if ce else None
        fg.run(1)
        if ce is not None:
            if ce.num_packets == n_before and tx is not None:
                # frame lost entirely (not even detected): report the
                # failure on the commanded config so the engine learns
                fg.nodes["ce"].deliver(
                    "packet_info",
                    {
                        "header_valid": 0,
                        "payload_valid": 0,
                        "modulation": tx.modulation,
                        "inner_code": tx.inner_code,
                        "outer_code": tx.outer_code,
                    },
                )
            goodputs.append(ce.store.rx_log[-1].throughput)
            if (pkt + 1) % 25 == 0:
                print(
                    f"pkt {pkt + 1:4d}: avg goodput(25)={np.mean(goodputs[-25:]):.3f} "
                    f"bit/sym  config=({tx.modulation},{tx.inner_code},{tx.outer_code})"
                )

    recovered = None
    if rx is not None:
        recovered = rx.num_packets
        print(f"rx packets decoded: {recovered}/{args.packets}")
    if ce is not None and goodputs:
        print(f"final avg goodput (last 50): {np.mean(goodputs[-50:]):.3f} bit/sym")
    if ce is None and rx is not None and recovered < args.packets:
        sys.exit(1)
    return {"recovered": recovered, "goodputs": goodputs}


if __name__ == "__main__":
    main()
