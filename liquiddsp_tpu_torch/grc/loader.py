"""Flowgraph loader: the GRC runtime analog for the declarative layer.

Counterpart of ``liquiddsp_tpu/grc/loader.py``. The reference installs GRC
block descriptors that GNU Radio Companion turns into running flowgraphs
(factory + parameters + ports -> instantiated blocks wired through message
ports). This module consumes this package's YAML descriptors
(liquiddsp_tpu_torch/grc/*.yaml, each ``factory`` a class of this package):

- ``BlockDescriptor``: parsed block YAML: factory path, typed parameters
  (int / real / enum with validation), input ports (each names the
  ``handler`` method the loader calls, and optionally ``returns``: the
  output port fed by the handler's return value), output ports (by
  default published on the block instance's own MessageBus).
- ``Flowgraph``: parsed flowgraph YAML: named block instances with
  parameter overrides plus ``connections`` wiring ``src.port ->
  dst.port``; ``run(n)`` steps every source block n times, message
  propagation is synchronous through the wiring (the GR scheduler's
  msg-port semantics collapsed to direct calls, runtime/bus.py).

Every factory that takes a ``device`` (FlexTx, FlexRx, FrameDetectorCC,
ChannelModel) gets the loader's: ``None`` means the GPU.

Driven end to end by ``python -m liquiddsp_tpu_torch.apps.flowgraph_demo``
(loopback and the closed adaptation loop from grc/graphs/*.yaml).
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import os
from typing import Any, Callable

import yaml

_GRC_DIR = os.path.dirname(os.path.abspath(__file__))
GRAPHS_DIR = os.path.join(_GRC_DIR, "graphs")


@dataclasses.dataclass
class PortSpec:
    id: str
    domain: str
    handler: str | None = None  # inputs: method name on the block instance
    returns: str | None = None  # inputs: output port fed by handler's return


@dataclasses.dataclass
class ParamSpec:
    id: str
    dtype: str  # int | real | enum | str | bool
    default: Any = None
    options: list | None = None

    def coerce(self, value):
        if self.dtype == "int":
            return int(value)
        if self.dtype == "real":
            return float(value)
        if self.dtype == "bool":
            return bool(value)
        if self.dtype == "enum":
            v = str(value)
            if self.options and v not in [str(o) for o in self.options]:
                raise ValueError(
                    f"parameter {self.id}: {v!r} not in {self.options}"
                )
            return v
        return value


@dataclasses.dataclass
class BlockDescriptor:
    id: str
    label: str
    factory: str
    parameters: dict[str, ParamSpec]
    inputs: dict[str, PortSpec]
    outputs: dict[str, PortSpec]

    @classmethod
    def load(cls, name_or_path: str) -> "BlockDescriptor":
        """Load a descriptor by file path or short name (``flex_tx`` ->
        liquiddsp_tpu_torch/grc/flex_tx.yaml)."""
        path = name_or_path
        if not os.path.exists(path):
            path = os.path.join(_GRC_DIR, f"{name_or_path}.yaml")
        with open(path) as fh:
            d = yaml.safe_load(fh)
        params = {
            p["id"]: ParamSpec(
                p["id"], p.get("dtype", "str"), p.get("default"), p.get("options")
            )
            for p in d.get("parameters", [])
        }
        mk = lambda p: PortSpec(
            p["id"], p.get("domain", "message"), p.get("handler"), p.get("returns")
        )
        return cls(
            id=d["id"],
            label=d.get("label", d["id"]),
            factory=d["factory"],
            parameters=params,
            inputs={p["id"]: mk(p) for p in d.get("inputs", [])},
            outputs={p["id"]: mk(p) for p in d.get("outputs", [])},
        )

    def instantiate(self, overrides: dict | None = None, device=None):
        """factory(**typed_params): unknown override keys are rejected,
        values are coerced/validated per the declared dtype. A factory that
        takes a ``device`` gets ``device`` (``None``: the GPU)."""
        overrides = overrides or {}
        unknown = set(overrides) - set(self.parameters)
        if unknown:
            raise ValueError(f"{self.id}: unknown parameters {sorted(unknown)}")
        kwargs = {}
        for pid, spec in self.parameters.items():
            val = overrides.get(pid, spec.default)
            if val is not None:
                kwargs[pid] = spec.coerce(val)
        mod_path, cls_name = self.factory.rsplit(".", 1)
        factory = getattr(importlib.import_module(mod_path), cls_name)
        if "device" in inspect.signature(factory).parameters:
            kwargs["device"] = device
        return factory(**kwargs)


class _Node:
    """A placed block: instance + descriptor + outgoing wires."""

    def __init__(self, name: str, desc: BlockDescriptor, obj):
        self.name = name
        self.desc = desc
        self.obj = obj
        self.wires: dict[str, list[Callable[[Any], None]]] = {}

    def emit(self, port: str, msg: Any):
        if msg is None:
            return
        for sink in self.wires.get(port, []):
            sink(msg)

    def deliver(self, port: str, msg: Any):
        spec = self.desc.inputs.get(port)
        if spec is None:
            raise KeyError(f"{self.name}: no input port {port!r}")
        if spec.handler is None:
            raise ValueError(
                f"{self.desc.id}.{port}: descriptor declares no handler"
            )
        out = getattr(self.obj, spec.handler)(msg)
        if spec.returns:
            self.emit(spec.returns, out)


class Flowgraph:
    """Instantiate + wire a flowgraph YAML; see module docstring."""

    def __init__(self, nodes: dict[str, _Node]):
        self.nodes = nodes

    @property
    def blocks(self) -> dict[str, Any]:
        return {n: node.obj for n, node in self.nodes.items()}

    @classmethod
    def load(cls, path: str, device=None) -> "Flowgraph":
        """Instantiate and wire the graph of ``path``, every block that takes
        a device on ``device`` (``None``: the GPU)."""
        with open(path) as fh:
            g = yaml.safe_load(fh)
        nodes: dict[str, _Node] = {}
        for b in g["blocks"]:
            desc = BlockDescriptor.load(b["block"])
            obj = desc.instantiate(b.get("parameters"), device=device)
            nodes[b["name"]] = _Node(b["name"], desc, obj)
        fg = cls(nodes)
        for conn in g.get("connections", []):
            if isinstance(conn, str):
                src, dst = [c.strip() for c in conn.split("->")]
            else:
                src, dst = conn
            fg._connect(src, dst)
        return fg

    def _connect(self, src: str, dst: str):
        s_name, s_port = src.split(".")
        d_name, d_port = dst.split(".")
        s_node, d_node = self.nodes[s_name], self.nodes[d_name]
        if s_port not in s_node.desc.outputs:
            raise KeyError(f"{s_name}: no output port {s_port!r}")
        sink = lambda msg, n=d_node, p=d_port: n.deliver(p, msg)
        # outputs fed by a handler's return value route through node.emit;
        # everything else is published on the block's own MessageBus
        returns_fed = {
            spec.returns for spec in s_node.desc.inputs.values() if spec.returns
        }
        if s_port in returns_fed:
            s_node.wires.setdefault(s_port, []).append(sink)
        else:
            bus = getattr(s_node.obj, "bus", None)
            if bus is None:
                raise ValueError(
                    f"{s_node.desc.id} has no bus to publish {s_port!r}"
                )
            bus.subscribe(s_port, sink)

    def run(self, iterations: int = 1):
        """Step every source block (an instance with a ``step()`` method
        and no declared inputs) ``iterations`` times; messages cascade
        synchronously through the wiring."""
        sources = [
            n for n in self.nodes.values()
            if not n.desc.inputs and hasattr(n.obj, "step")
        ]
        if not sources:
            raise ValueError("flowgraph has no source blocks to step")
        for _ in range(iterations):
            for n in sources:
                n.obj.step()
