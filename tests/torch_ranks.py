"""Runs a function in N fresh processes joined by one gloo process group
(the CPU stand-in for a mesh of cards), for the port's multi-rank tests.

``run_ranks(n, "body_name", payload, tmp)`` starts ``n`` processes of this
file; each joins the group through a ``FileStore`` under ``tmp`` (no fixed
port: xdist runs several workers), calls ``BODIES[body_name](rank,
payload)`` and writes its pickled result. Bodies import torch and the port
only; the reference side of each test runs in the test's own process.
Every group is destroyed when its process ends, so nothing is left in the
test worker.
"""

from __future__ import annotations

import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


class Ranks:
    """``n`` started processes of this file running one body; ``wait()``
    returns their results (the caller may work meanwhile)."""

    def __init__(self, n: int, body: str, payload, tmp, timeout: float = 240.0):
        self.n, self.body, self.tmp, self.timeout = n, body, Path(tmp), timeout
        self.tmp.mkdir(parents=True, exist_ok=True)
        (self.tmp / "payload.pkl").write_bytes(pickle.dumps(payload))
        (self.tmp / "store").unlink(missing_ok=True)  # a FileStore must start empty
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]),
               "OMP_NUM_THREADS": "1"}
        self.logs = [open(self.tmp / f"rank{r}.log", "w+") for r in range(n)]
        self.procs = [subprocess.Popen([sys.executable, __file__, body, str(r), str(n), str(self.tmp)],
                                       env=env, stdout=self.logs[r], stderr=subprocess.STDOUT, cwd=str(REPO))
                      for r in range(n)]

    def wait(self) -> list:
        try:
            for p in self.procs:
                p.wait(timeout=self.timeout)
        finally:
            for p in self.procs:
                if p.poll() is None:  # hung: its threads' stacks into its log, then gone
                    p.send_signal(signal.SIGABRT)
                    try:
                        p.wait(timeout=5)
                    except subprocess.TimeoutExpired:
                        p.kill()
            for f in self.logs:
                f.close()
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            log = (self.tmp / f"rank{bad[0]}.log").read_text()
            raise RuntimeError(f"rank {bad[0]} of {self.n} ({self.body}) exited {self.procs[bad[0]].returncode}:"
                               f"\n{log[-6000:]}")
        return [pickle.loads((self.tmp / f"out{r}.pkl").read_bytes()) for r in range(self.n)]


def run_ranks(n: int, body: str, payload, tmp, timeout: float = 240.0) -> list:
    return Ranks(n, body, payload, tmp, timeout).wait()


# ---------------------------------------------------------------------------
# bodies: (rank, payload) -> a picklable result
# ---------------------------------------------------------------------------


def _tiny_gpt(payload):
    from ray_tpu_torch.models.gpt import GPTConfig, params_from_jax

    cfg = GPTConfig(**payload["cfg"])
    return cfg, params_from_jax(payload["tree"], cfg, "cpu")


def _local_bytes(tensors) -> int:
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes for t in tensors)


def parallel_modes(rank: int, payload) -> dict:
    """test_torch_parallel.py: per mesh in ``payload["meshes"]``, one SGD
    step of the tiny GPT (loss and updated parameters), per-rank parameter
    and AdamW-moment bytes, AdamW losses over ``payload["adam_steps"]``;
    then ``global_put`` and ``mesh_allreduce``."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.collective import ReduceOp, mesh_allreduce
    from ray_tpu_torch.models.gpt import gpt_loss, params_to_numpy
    from ray_tpu_torch.parallel import MeshConfig, adamw, build_train_step, global_put, make_mesh
    from ray_tpu_torch.parallel.sharding import param_mesh

    out = {}
    batch = torch.from_numpy(payload["batch"])
    for name, axes in payload["meshes"].items():
        mesh = make_mesh(MeshConfig(sp=1, **axes), devices="cpu")
        cfg, params = _tiny_gpt(payload)

        def loss_fn(p, t, cfg=cfg, mesh=mesh):
            return gpt_loss(cfg, p, t, mesh)

        init_fn, step_fn = build_train_step(loss_fn, lambda ps: torch.optim.SGD(ps, lr=0.1), mesh)
        state = init_fn(params)
        state, loss = step_fn(state, batch)
        res = {"loss": loss.item(), "params": params_to_numpy(state.params)}
        cfg, params = _tiny_gpt(payload)
        init_fn, step_fn = build_train_step(lambda p, t, cfg=cfg, mesh=mesh: gpt_loss(cfg, p, t, mesh),
                                            adamw(1e-2), mesh)
        state = init_fn(params)
        moments = [s[k] for s in state.opt_state.state.values() for k in ("exp_avg", "exp_avg_sq")]
        res["all_dtensors"] = all(isinstance(t, DTensor) and t.device_mesh == param_mesh(mesh)
                                  for t in [*state.params.parameters(), *moments])
        res["same_placements"] = all(
            s["exp_avg"].placements == p.placements == s["exp_avg_sq"].placements
            for p, s in state.opt_state.state.items())
        res["param_bytes"] = _local_bytes(state.params.parameters())
        res["moment_bytes"] = _local_bytes(moments)
        losses = []
        for _ in range(payload["adam_steps"]):
            state, loss = step_fn(state, batch)
            losses.append(loss.item())
        res["adam_losses"] = losses
        res["moment_bytes_after"] = _local_bytes(
            s[k] for s in state.opt_state.state.values() for k in ("exp_avg", "exp_avg_sq"))
        out[name] = res

    mesh = make_mesh(MeshConfig(dp=2, fsdp=2, tp=2, sp=1), devices="cpu")
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    put = global_put(x, mesh, (("dp", "fsdp"), "tp"))
    out["global_put"] = {"local": put.to_local().numpy(), "full": put.full_tensor().numpy(),
                         "placements": [str(p) for p in put.placements]}
    rng = np.random.RandomState(payload["allreduce_seed"])
    xr = torch.from_numpy(rng.randint(-4, 5, size=(16, 5)).astype(np.float32))
    out["allreduce"] = {op.name: mesh_allreduce(xr, op=op).numpy() for op in ReduceOp}
    out["allreduce_on"] = mesh_allreduce(xr, make_mesh(MeshConfig(dp=2, fsdp=2, tp=2, sp=1),
                                                       devices="cpu")).numpy()
    return out


def pipeline_cases(rank: int, payload) -> dict:
    """test_torch_pipeline.py: every case of ``payload["cases"]`` on its
    ranks, ``(name, ranks, mesh shape, axis names, pp, microbatches, batch
    axes, grads)``: the output (and, with grads, the loss's gradient of each
    stacked parameter, through pp-sharded ``DTensor`` parameters)."""
    import torch

    from ray_tpu_torch.parallel.mesh import mesh_from_ranks
    from ray_tpu_torch.parallel.pipeline import pipeline_apply
    from ray_tpu_torch.parallel.sharding import global_put

    def stage_fn(params, x):
        for w, b in zip(params["w"], params["b"]):
            x = torch.tanh(x @ w + b)
        return x

    out = {}
    for name, ranks, shape, names, n_layers, microbatches, batch_axes, grads in payload["cases"]:
        import numpy as np

        mesh = mesh_from_ranks("cpu", np.asarray(ranks).reshape(shape), names)
        if rank not in ranks:
            continue
        data = payload["data"][name]
        x = torch.from_numpy(data["x"])
        params = {k: torch.from_numpy(v) for k, v in data["params"].items()}
        if not grads:
            out[name] = pipeline_apply(stage_fn, params, x, mesh, n_layers, microbatches,
                                       batch_axes=batch_axes).numpy()
            continue
        leaves = {k: global_put(v, mesh, ("pp",)).requires_grad_() for k, v in params.items()}
        y = pipeline_apply(stage_fn, leaves, x, mesh, n_layers, microbatches, batch_axes=batch_axes)
        ((y - torch.from_numpy(data["tgt"])) ** 2).mean().backward()
        out[name] = {k: v.grad.full_tensor().numpy() for k, v in leaves.items()}
    return out


def _tiny_state(payload, mesh):
    from ray_tpu_torch.models.gpt import gpt_loss
    from ray_tpu_torch.parallel import adamw, build_train_step

    cfg, params = _tiny_gpt(payload)
    init_fn, step_fn = build_train_step(lambda p, t: gpt_loss(cfg, p, t, mesh), adamw(1e-2), mesh)
    return init_fn(params), step_fn


def _moments(state) -> dict:
    """Each parameter's AdamW moments, whole and in the unsharded layout
    (copies: a replicated moment's whole value is its local tensor, which
    later steps change)."""
    import numpy as np

    from ray_tpu_torch.parallel.sharding import full_value

    names = {p: n for n, p in state.params.named_parameters()}
    return {f"{names[p]}.{k}": np.array(full_value(s[k], fused_qkv="attn_qkv" in names[p]).numpy())
            for p, s in state.opt_state.state.items() for k in ("exp_avg", "exp_avg_sq")}


def checkpoint_save(rank: int, payload) -> dict:
    """test_torch_train_integrations.py: the tiny GPT's train state on the
    mesh ``payload["save_mesh"]`` of every rank, one AdamW step, saved with
    ``save_pytree_checkpoint``; then a second step's loss."""
    import torch

    from ray_tpu_torch.models.gpt import params_to_numpy
    from ray_tpu_torch.parallel import MeshConfig, make_mesh, train_state_dict
    from ray_tpu_torch.train.integrations import save_pytree_checkpoint

    mesh = make_mesh(MeshConfig(**payload["save_mesh"]), devices="cpu")
    state, step_fn = _tiny_state(payload, mesh)
    batch = torch.from_numpy(payload["batch"])
    state, _ = step_fn(state, batch)
    save_pytree_checkpoint(train_state_dict(state), payload["path"])
    files = sorted(os.listdir(os.path.join(payload["path"], "pytree")))
    placements = {str(p.placements) for p in state.params.parameters()}
    params, moments = params_to_numpy(state.params), _moments(state)
    state, loss = step_fn(state, batch)
    return {"files": files, "params": params, "moments": moments, "next_loss": loss.item(),
            "step": state.step, "placements": placements}


def checkpoint_restore(rank: int, payload) -> dict:
    """The same train state built fresh on the mesh
    ``payload["restore_mesh"]`` of every rank (another count or layout),
    restored from ``payload["path"]`` with a target, then one step."""
    import torch

    from ray_tpu_torch.models.gpt import params_to_numpy
    from ray_tpu_torch.parallel import MeshConfig, make_mesh, train_state_dict
    from ray_tpu_torch.train.integrations import load_pytree_checkpoint

    mesh = make_mesh(MeshConfig(**payload["restore_mesh"]), devices="cpu")
    state, step_fn = _tiny_state(payload, mesh)
    restored = load_pytree_checkpoint(payload["path"], target=train_state_dict(state))
    state = state._replace(step=restored["step"])
    placements = {str(p.placements) for p in state.params.parameters()}
    params, moments = params_to_numpy(state.params), _moments(state)
    state, loss = step_fn(state, torch.from_numpy(payload["batch"]))
    return {"params": params, "moments": moments, "next_loss": loss.item(), "step": state.step,
            "placements": placements}


def module_bridge_steps(rank: int, payload) -> dict:
    """The module bridge on a (dp 2, fsdp 2) mesh: an MLP (the reference's
    flax test's) from the reference's weights, Adam 1e-2 over the same
    batch; the losses and each weight's placements."""
    import torch

    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.train.integrations import build_module_train_step

    class MLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1, self.fc2 = torch.nn.Linear(32, 256), torch.nn.Linear(256, 8)

        def forward(self, batch):
            return self.fc2(torch.relu(self.fc1(batch["x"])))

    def loss_fn(apply_fn, params, batch):
        logits = apply_fn(params, batch)
        return torch.nn.functional.cross_entropy(logits, batch["y"].long())

    module = MLP()
    with torch.no_grad():
        for name, value in payload["weights"].items():
            module.get_parameter(name).copy_(torch.from_numpy(value))
    mesh = make_mesh(MeshConfig(dp=2, fsdp=2, tp=1, sp=1), devices="cpu")
    out = {}
    for label, overrides in (("plain", None), ("overrides", [(r"fc2\.weight", (None, None))])):
        module_copy = MLP()
        module_copy.load_state_dict(module.state_dict())
        init_fn, step_fn = build_module_train_step(
            module_copy, loss_fn, lambda ps: torch.optim.Adam(ps, lr=1e-2), mesh, payload["batch"],
            min_shard_size=1024, sharding_overrides=overrides)
        state = init_fn()
        out[label] = {"placements": {n: [str(p) for p in w.placements]
                                     for n, w in state.params.named_parameters()}}
        if label == "plain":
            losses = []
            for _ in range(payload["steps"]):
                state, loss = step_fn(state, payload["batch"])
                losses.append(loss.item())
            out[label]["losses"] = losses
    return out


def flash_sharded(rank: int, payload) -> dict:
    """test_torch_flash_sharded.py: ``flash_attention_sharded`` on global
    ``DTensor`` q, k, v (batch over dp, heads over tp) on a (dp 2, tp 2)
    mesh: the output and the gradients of ``(out * w).sum()``, gathered,
    and what each rank attended locally."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.parallel.sharding import global_put

    mesh = make_mesh(MeshConfig(dp=2, fsdp=1, tp=2, sp=1), devices="cpu")
    spec = (("dp", "fsdp"), "tp", None, None)
    q, k, v = (global_put(torch.from_numpy(payload[n]), mesh, spec).requires_grad_() for n in "qkv")
    local_shapes = []
    attend = fa.flash_attention

    def counting(q_, k_, v_):
        local_shapes.append(tuple(q_.shape))
        return attend(q_, k_, v_)

    fa.flash_attention = counting
    try:
        out = fa.flash_attention_sharded(q, k, v, mesh)
    finally:
        fa.flash_attention = attend
    (out.to_local() * torch.from_numpy(payload["w"])).sum().backward()  # each rank its shard's terms
    return {"out": out.full_tensor().detach().numpy(), "placements": [str(p) for p in out.placements],
            "grads": [t.grad.full_tensor().numpy() for t in (q, k, v)], "local_shapes": local_shapes,
            "shardable": [fa.flash_shardable(2, 4, mesh), fa.flash_shardable(3, 4, mesh),
                          fa.flash_shardable(2, 3, mesh)]}


def gpt_mesh_cases(rank: int, payload) -> dict:
    """test_torch_moe_mesh.py and test_torch_ring_attention.py: each case
    of ``payload["cases"]`` on the mesh of its ranks (``axes`` of
    ``MeshConfig``), a GPT of ``cfg`` from the reference's tree
    ``trees[tree]`` and the batch ``tokens[tokens]``. ``what``: "forward"
    (on sharded parameters: the rank's logits of ``gpt_forward`` with the
    first row and position they start at, the aux, and the global mean of
    ``gpt_loss``), "sgd" (one SGD step, lr 0.1: the loss and the whole
    parameters), "bytes" (per-rank parameter and AdamW moment bytes) or
    "adam" (``steps`` AdamW steps, lr 1e-3: the losses)."""
    import torch

    from ray_tpu_torch.models.gpt import GPTConfig, gpt_forward, gpt_loss, params_from_jax, params_to_numpy
    from ray_tpu_torch.parallel import MeshConfig, adamw, build_train_step, make_mesh
    from ray_tpu_torch.parallel.mesh import axis_size
    from ray_tpu_torch.parallel.sharding import batch_spec, local_slices, shard_params
    from ray_tpu_torch.parallel.train_step import global_mean

    out = {}
    for case in payload["cases"]:
        mesh = make_mesh(MeshConfig(**case["axes"]), devices=("cpu", case["ranks"]))
        if rank not in case["ranks"]:
            continue
        cfg = GPTConfig(**case["cfg"])
        params = params_from_jax(payload["trees"][case["tree"]], cfg, "cpu")
        tokens = torch.from_numpy(payload["tokens"][case["tokens"]])

        def loss_fn(p, t, cfg=cfg, mesh=mesh):
            return gpt_loss(cfg, p, t, mesh)

        if case["what"] == "forward":
            shard_params(params, mesh)
            rows = local_slices(tokens.shape, batch_spec(), mesh)[0]
            with torch.no_grad():
                logits, aux = gpt_forward(cfg, params, tokens[rows, :-1], mesh, return_aux=True)
                loss = global_mean(loss_fn(params, tokens[rows]), mesh)
            sp = axis_size(mesh, "sp")
            off = (mesh.get_local_rank("sp") if sp > 1 else 0) * (cfg.seq_len // sp)
            res = dict(logits=logits.numpy(), at=(rows.start or 0, off), aux=aux.item(), loss=loss.item())
        elif case["what"] == "sgd":
            init_fn, step_fn = build_train_step(loss_fn, lambda ps: torch.optim.SGD(ps, lr=0.1), mesh)
            state, loss = step_fn(init_fn(params), tokens)
            res = dict(loss=loss.item(), params=params_to_numpy(state.params))
        elif case["what"] == "bytes":
            state = build_train_step(loss_fn, adamw(1e-2), mesh)[0](params)
            moments = [s[k] for s in state.opt_state.state.values() for k in ("exp_avg", "exp_avg_sq")]
            res = dict(param_bytes=_local_bytes(state.params.parameters()), moment_bytes=_local_bytes(moments))
        else:
            init_fn, step_fn = build_train_step(loss_fn, adamw(1e-3), mesh)
            state, losses = init_fn(params), []
            for _ in range(case["steps"]):
                state, loss = step_fn(state, tokens)
                losses.append(loss.item())
            res = dict(losses=losses)
        out[case["name"]] = res
    return out


def ring_cases(rank: int, payload) -> dict:
    """test_torch_ring_attention.py: ``ring_attention_sharded`` for each
    case ``(name, ranks, axes)`` of ``payload["cases"]`` on the mesh of its
    ranks, on q, k, v placed batch over (dp, fsdp), heads over tp, seq
    over sp: the output and the gradients of ``(out * w).sum()``,
    gathered."""
    import torch

    from ray_tpu_torch.ops.ring_attention import ring_attention_sharded
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.parallel.sharding import global_put

    out = {}
    for name, ranks, axes in payload["cases"]:
        mesh = make_mesh(MeshConfig(**axes), devices=("cpu", ranks))
        if rank not in ranks:
            continue
        data = payload["data"][name]
        spec = (("dp", "fsdp"), "tp", "sp", None)
        q, k, v = (global_put(torch.from_numpy(data[n]), mesh, spec).requires_grad_() for n in "qkv")
        att = ring_attention_sharded(q, k, v, mesh)
        (att.to_local() * torch.from_numpy(data["w"])).sum().backward()  # each rank its shard's terms
        out[name] = {"out": att.full_tensor().detach().numpy(), "placements": [str(p) for p in att.placements],
                     "grads": [t.grad.full_tensor().numpy() for t in (q, k, v)]}
    return out


BODIES = {"parallel_modes": parallel_modes, "flash_sharded": flash_sharded, "pipeline_cases": pipeline_cases,
          "checkpoint_save": checkpoint_save, "checkpoint_restore": checkpoint_restore,
          "module_bridge_steps": module_bridge_steps, "gpt_mesh_cases": gpt_mesh_cases,
          "ring_cases": ring_cases}


def several(rank: int, payload) -> list:
    """Each ``(body, payload)`` of ``payload`` in turn, in one launch."""
    return [BODIES[name](rank, p) for name, p in payload]


BODIES["several"] = several


def _main(body: str, rank: int, world: int, tmp: str) -> None:
    import faulthandler

    import torch
    import torch.distributed as dist

    faulthandler.enable()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                           rank=rank, world_size=world)
    try:
        payload = pickle.loads(Path(tmp, "payload.pkl").read_bytes())
        result = BODIES[body](rank, payload)
        Path(tmp, f"out{rank}.pkl").write_bytes(pickle.dumps(result))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
