"""SPMD parallelism over device meshes (port of ``ray_tpu/parallel/``).

* data parallel → the ``dp`` mesh axis: each rank steps on its batch slice,
  gradients summed by the backward of the parameters' gathers;
* sharded data parallel (ZeRO-3) → ``fsdp``: parameters and Adam state
  live as ``DTensor`` shards, all-gathered per block on use,
  reduce-scattered in the backward;
* tensor parallel (Megatron) → ``tp``, on the weight matrices;
* expert parallel → ``ep``: each rank computes its share of a mixture of
  experts on the tokens its group shares;
* sequence parallel → ``sp``: each rank its chunk of the positions, ring
  attention (``ops.ring_attention``) across the chunks;
* pipeline parallel → ``pipeline_apply`` over a ``pp`` axis (GPipe).

One ``DeviceMesh`` (``make_mesh``) and one rule table (``sharding``) drive
it all; ``build_train_step(loss_fn, optimizer, mesh)`` is the step, and
without a mesh the one-device step with ``adamw``.
"""

from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh  # noqa: F401
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    NamedSharding,
    batch_spec,
    constrain,
    param_sharding_rules,
    shard_params,
)
from ray_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState,
    adamw,
    build_train_step,
    global_put,
    profile_step_fn,
    train_state_dict,
)
