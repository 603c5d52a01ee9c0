"""The cognitive engine: the 616-arm adaptation state and its bandits.

Counterpart of ``liquiddsp_tpu/engine/``, kept as this package's own copy
(bit-exact with it: the same store arrays, logs and decisions for the same
feedback and seed). The engine runs on the host, in numpy and scipy, with
Python's ``random.Random(seed)``: each decision is a host value that
configures the next transmission, and its inputs are a few scalars a packet.
Moving the 616-element arm arrays to the GPU would add a device round trip
per packet and gain nothing.
"""

from liquiddsp_tpu_torch.engine.cognitive_engine import CognitiveEngineBlock  # noqa: F401
from liquiddsp_tpu_torch.engine.store import ArmStore  # noqa: F401
from liquiddsp_tpu_torch.engine.bandits import CognitiveEngine  # noqa: F401
from liquiddsp_tpu_torch.engine.knowledge import KnowledgeIndicator  # noqa: F401
