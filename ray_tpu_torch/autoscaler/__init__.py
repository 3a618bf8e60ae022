"""ray_tpu_torch.autoscaler: demand-driven cluster scaling.

Reference: ``python/ray/autoscaler/`` — ``StandardAutoscaler.update``
(``_private/autoscaler.py:171,373``) driven by a monitor loop, launching
nodes through pluggable cloud ``NodeProvider``s, with the in-process
``FakeMultiNodeProvider`` (``_private/fake_multi_node/node_provider.py:237``)
powering e2e tests on one machine.

The port's copy of ``ray_tpu/autoscaler``: the same names, instance
states, config schema and cloud REST calls; the autoscalers also offer
their node types' shapes to the head, so that GPU demand waits for a GPU
node they can buy (``_private/head.py``, ``rpc_autoscaler_offer``).
"""

from ray_tpu_torch.autoscaler.autoscaler import Monitor, StandardAutoscaler  # noqa: F401
from ray_tpu_torch.autoscaler.node_provider import (  # noqa: F401
    FakeNodeProvider,
    GKETPUNodeProvider,
    NodeProvider,
)
from ray_tpu_torch.autoscaler.v2 import (  # noqa: F401
    AsyncNodeProvider,
    AutoscalerV2,
    FakeAsyncProvider,
    InstanceManager,
)
