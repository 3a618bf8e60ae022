"""ray_tpu_torch.serve: online model serving on the port's task/actor
runtime (copy of ``ray_tpu/serve/``).

The capability surface: ``@serve.deployment`` + ``.bind()`` + ``serve.run``
(api.py), controller reconciliation into replica actors (controller.py /
replica.py), handle-side power-of-two-choices routing (handle.py),
``@serve.batch`` coalescing (batching.py: concurrent requests meet the
model as ONE batch), queue-depth autoscaling, composition via handles, the
HTTP ingress (proxy.py) and the gRPC ingress (grpc_proxy.py). ``serve.llm``
serves the port's paged engine from a GPU replica.

Nothing here imports torch: the controller, the proxies and the routers run
in workers forked from the runtime's template, which must never map torch
or CUDA. Deployment specs carry the user's class and bind arguments sealed
(``_private.common.Sealed``), so the controller never unpickles them either;
only a replica opens them, and only ``serve.llm``'s replica imports torch.
"""

from ray_tpu_torch.serve.api import (  # noqa: F401
    Application,
    Deployment,
    delete,
    deployment,
    get_app_handle,
    get_deployment_handle,
    run,
    run_config,
    shutdown,
    status,
)
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.multiplex import (  # noqa: F401
    get_multiplexed_model_id,
    multiplexed,
)
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse  # noqa: F401
from ray_tpu_torch.serve._private.common import AutoscalingConfig  # noqa: F401
