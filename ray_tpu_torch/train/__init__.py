"""ray_tpu_torch.train — training over the port's runtime (copy of
``ray_tpu/train/``).

Public surface mirrors the reference's ``ray.train`` (SURVEY §2.3): configs,
Checkpoint, session functions (report/get_context/get_checkpoint/
get_dataset_shard), DataParallelTrainer/TorchTrainer, Result, and
``save_state``/``load_state`` for a ``parallel.train_step.TrainState``.
Nothing here imports torch until a train loop or a checkpoint of tensors
needs it, so the runtime's workers start light. The reference's orbax and
flax bridges are not ported (``integrations``).
"""

from ray_tpu_torch.train._checkpoint import (  # noqa: F401
    Checkpoint,
    load_pytree,
    load_state,
    save_pytree,
    save_state,
)
from ray_tpu_torch.train._config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchConfig,
)
from ray_tpu_torch.train._session import (  # noqa: F401
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.trainer import (  # noqa: F401
    DataParallelTrainer,
    Result,
    TorchTrainer,
)
from ray_tpu_torch.train._backend_executor import TorchBackend  # noqa: F401
