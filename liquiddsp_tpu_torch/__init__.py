"""liquiddsp_tpu_torch: the PyTorch/CUDA port of the flexframe PHY.

A second package beside the JAX package ``liquiddsp_tpu``, which stays the
reference. This package imports ``torch`` and numpy only. Its kernels are
CUDA C++ sources under ``csrc/``, compiled with ``nvcc`` for ``sm_90a`` at
first use (``kernels/_cuda.py``); each has a plain PyTorch version beside it
that is taken only for tensors that lie on the CPU.

Ported so far: the single-device block receiver, TX ``phy.framegen.framegen``
-> RX ``phy.framesync.framesync_fixed``, and the time-sharded receiver on one
device or over the ranks of a process group (``parallel.mesh.init_distributed``,
the halo kernel pushing into a peer process's window through CUDA IPC):
``parallel.halo.sharded_framesync``, its streaming wrapper
``runtime.distributed_stream.ShardedStreamingRx`` and
``utils.metrics.LinkMetrics``; the self-describing receiver
``runtime.blocks.FlexRx``; the continuous streaming receiver
``runtime.stream.StreamingRx`` with ``runtime.supervisor`` and
``runtime.native``; the cognitive engine ``engine`` (host code) and the
closed adaptation loop ``adapt_loop.adapt_loop``; the resampled receiver
(``ops.resample.arbitrary_groups`` ahead of ``framesync_fixed``) with the
rest of ``ops`` (AGC, NCO, FIR, the integer resamplers); the golden
oracle's binding ``golden``; and the flowgraph layer ``grc``, with the
demos under ``apps`` (loopback, flowgraph, adaptation, supervised rx, and
``sharded_rx_demo``, the launcher of the receiver across processes). Entry
points run on the GPU unless the caller passes ``device="cpu"``.
``dryrun_sharded(n_time)`` is the quick proof of the sharded path.
"""

from liquiddsp_tpu_torch.core.config import (  # noqa: F401
    FrameConfig,
    InnerCode,
    Modulation,
    OuterCode,
)

from liquiddsp_tpu_torch.dryrun import dryrun_sharded  # noqa: F401

__version__ = "0.2.0"
