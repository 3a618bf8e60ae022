"""TuneController: the trial event loop (copy of
``ray_tpu/tune/controller.py``).

Reference: ``python/ray/tune/execution/tune_controller.py:72`` (``step``
:709): launch trial actors up to the concurrency budget, consume reported
results, route them through the scheduler (CONTINUE/STOP/EXPLOIT), commit
checkpoints, checkpoint experiment state, finalize. Under synchronous PBT
(``PopulationBasedTraining(synch=True)``) a trial at a perturbation point is
held, unacknowledged, until every running trial is held, and then each gets
its decision.

Trial execution reuses the train worker machinery: a trial is one
``RayTrainWorker`` actor running the trainable in a ``_TrainSession`` whose
``report``/``get_checkpoint`` are the same functions used under
``ray_tpu_torch.train`` (the reference unified these APIs the same way).

A trial that asks for ``GPU`` gets its card as a train worker does
(``RayTrainWorker.bind_cards``, fractional shares packed onto one card)
before its trainable runs; on a cluster with no GPU the controller raises
at once, as ``WorkerGroup`` does, rather than leave the trials pending.
A trial that asks for none takes no card, so a trainer started inside it
(``DataParallelTrainer.as_trainable``) places its own GPU workers.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Callable, Optional

import ray_tpu_torch
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._checkpoint_manager import CheckpointManager
from ray_tpu_torch.train._config import CheckpointConfig, FailureConfig
from ray_tpu_torch.train._session import TrainContext
from ray_tpu_torch.train._worker_group import RayTrainWorker
from ray_tpu_torch.tune import schedulers as sched_mod

PENDING, RUNNING, TERMINATED, ERROR = "PENDING", "RUNNING", "TERMINATED", "ERROR"


class Trial:
    def __init__(
        self,
        idx: int,
        config: dict,
        exp_dir: str,
        ckpt_config: CheckpointConfig,
        trial_id: Optional[str] = None,
        storage=None,  # experiment-level StorageContext (cloud persistence)
    ):
        self.id = trial_id or f"{idx:05d}_{uuid.uuid4().hex[:6]}"
        self.idx = idx
        self.config = config
        self.state = PENDING
        self.last_result: Optional[dict] = None
        self.results: list[dict] = []
        self.error: Optional[BaseException] = None
        self.actor = None
        self.iteration = 0
        self.retries_left = 0
        self.dir = os.path.join(exp_dir, f"trial_{self.id}")
        os.makedirs(self.dir, exist_ok=True)
        trial_storage = storage.for_trial(f"trial_{self.id}") if storage else None
        self.ckpt_manager = CheckpointManager(
            self.dir, ckpt_config, storage=trial_storage
        )
        self.start_checkpoint: Optional[Checkpoint] = None
        self._rungs_hit: set = set()

    @property
    def checkpoint(self) -> Optional[Checkpoint]:
        # start_checkpoint is an injected restore point (PBT exploit) that
        # outranks older own commits; it is cleared on the next own commit
        return self.start_checkpoint or self.ckpt_manager.latest()


class TuneController:
    def __init__(
        self,
        trainable: Callable,
        configs: list[dict],
        exp_dir: str,
        *,
        scheduler=None,
        metric: Optional[str] = None,
        mode: str = "min",
        max_concurrent: int = 8,
        resources_per_trial: Optional[dict[str, float]] = None,
        failure_config: Optional[FailureConfig] = None,
        checkpoint_config: Optional[CheckpointConfig] = None,
        verbose: int = 0,
        searcher=None,
        num_samples: int = 0,
        storage=None,  # StorageContext: checkpoints + experiment state ride pyarrow.fs
    ):
        self.trainable = trainable
        self.exp_dir = exp_dir
        self.storage = storage
        self._last_state_upload = float("-inf")
        os.makedirs(exp_dir, exist_ok=True)
        self.scheduler = scheduler or sched_mod.FIFOScheduler()
        self.metric, self.mode = metric, mode
        self.max_concurrent = max_concurrent
        self.resources = resources_per_trial or {"CPU": 1.0}
        self.failure_config = failure_config or FailureConfig()
        ckpt_config = checkpoint_config or CheckpointConfig()
        self.verbose = verbose
        self._ckpt_config = ckpt_config
        # sequential-searcher mode: trials are pulled from searcher.suggest
        # lazily as slots free up (reference: SearchGenerator); batch mode:
        # the pre-expanded config list.
        self.searcher = searcher
        self.num_samples = num_samples
        self._searcher_done = searcher is None
        self.trials = [
            Trial(i, c, exp_dir, ckpt_config, storage=storage)
            for i, c in enumerate(configs)
        ]
        for t in self.trials:
            t.retries_left = self.failure_config.max_failures
        self._held: list[Trial] = []  # synchronous PBT: trials waiting at a perturbation point

    # ------------------------------------------------------------------ loop

    def run(self) -> list[Trial]:
        if self.resources.get("GPU", 0) > 0 and not ray_tpu_torch.cluster_resources().get("GPU"):
            raise RuntimeError(
                f"tune trials require {dict(self.resources)}, but no node of this cluster "
                "has a GPU (GPU: 0)"
            )
        try:
            while (
                any(t.state in (PENDING, RUNNING) for t in self.trials)
                or not self._searcher_done
            ):
                self._pull_suggestions()
                self._launch_pending()
                progressed = self._poll_running()
                if not progressed:
                    time.sleep(0.02)
            return self.trials
        finally:
            for t in self.trials:
                self._stop_actor(t)
            self._save_experiment_state(force=True)  # final state must land

    def _pull_suggestions(self):
        """Ask the sequential searcher for new trials while slots are free."""
        if self._searcher_done:
            return
        from ray_tpu_torch.tune.searcher import FINISHED

        active = sum(1 for t in self.trials if t.state in (PENDING, RUNNING))
        while len(self.trials) < self.num_samples and active < self.max_concurrent:
            idx = len(self.trials)
            trial_id = f"{idx:05d}_{uuid.uuid4().hex[:6]}"
            out = self.searcher.suggest(trial_id)
            if out is None:
                return  # searcher wants to wait for completions
            if out == FINISHED:
                self._searcher_done = True
                self.num_samples = len(self.trials)
                return
            trial = Trial(
                idx, out, self.exp_dir, self._ckpt_config,
                trial_id=trial_id, storage=self.storage,
            )
            trial.retries_left = self.failure_config.max_failures
            self.trials.append(trial)
            active += 1
        if len(self.trials) >= self.num_samples:
            self._searcher_done = True

    def _notify_searcher_complete(self, trial: Trial, error: bool):
        if self.searcher is not None:
            try:
                self.searcher.on_trial_complete(
                    trial.id, result=trial.last_result, error=error
                )
            except Exception:
                pass

    def _launch_pending(self):
        running = sum(1 for t in self.trials if t.state == RUNNING)
        for t in self.trials:
            if running >= self.max_concurrent:
                return
            if t.state == PENDING:
                self._start_trial(t)
                running += 1

    def _start_trial(self, trial: Trial, checkpoint: Optional[Checkpoint] = None):
        cls = ray_tpu_torch.remote(num_cpus=0)(RayTrainWorker)
        trial.actor = cls.options(resources=dict(self.resources)).remote()
        gpus = float(self.resources.get("GPU", 0))
        if gpus > 0:
            # before the trainable touches CUDA: one process per trial
            ray_tpu_torch.get(trial.actor.bind_cards.remote(0, gpus))
        ctx = TrainContext(
            world_size=1, world_rank=0, local_rank=0, local_world_size=1, node_rank=0,
            experiment_name=os.path.basename(self.exp_dir),
            trial_name=f"trial_{trial.id}", trial_id=trial.id,
        )
        ckpt = checkpoint if checkpoint is not None else trial.checkpoint
        if checkpoint is not None:
            # remember an externally-injected restore point (PBT exploit) so a
            # crash before the trial's first own commit retries from it
            trial.start_checkpoint = checkpoint
        trial.actor.start_training.remote(self.trainable, trial.config, ctx, ckpt, None)
        trial.state = RUNNING
        if self.verbose:
            print(f"[tune] trial {trial.id} started config={trial.config}")

    def _stop_actor(self, trial: Trial):
        if trial.actor is not None:
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None

    def _poll_running(self) -> bool:
        progressed = False
        # fire all polls first so the 50ms waits overlap instead of serializing
        running = [t for t in self.trials if t.state == RUNNING]
        futures = [(t, t.actor.next_result.remote(0.05)) for t in running]
        for trial, fut in futures:
            if trial.state != RUNNING:
                continue  # stopped by a decision earlier in this round
            try:
                ev = ray_tpu_torch.get(fut, timeout=30.0)
            except Exception as e:
                self._on_trial_failure(trial, e)
                progressed = True
                continue
            if ev is None:
                continue
            progressed = True
            kind = ev[0]
            if kind == "result":
                self._on_result(trial, ev[1], ev[2])
            elif kind == "done":
                trial.state = TERMINATED
                self._stop_actor(trial)
                self._notify_searcher_complete(trial, error=False)
                self._save_experiment_state()
                self._release_held()
            elif kind == "error":
                self._on_trial_failure(trial, ev[1])
        return progressed

    def _on_result(self, trial: Trial, metrics: dict, reported_ckpt):
        trial.iteration += 1
        metrics = dict(metrics)
        metrics.setdefault("training_iteration", trial.iteration)
        metrics.setdefault("trial_id", trial.id)
        trial.last_result = metrics
        trial.results.append(metrics)
        if self.searcher is not None:
            try:
                self.searcher.on_trial_result(trial.id, metrics)
            except Exception:
                pass
        if reported_ckpt is not None:
            trial.ckpt_manager.commit(reported_ckpt, metrics)
            trial.start_checkpoint = None  # own commit supersedes any override
        decision = self.scheduler.on_result(trial, metrics)
        if decision == sched_mod.STOP:
            # ack first so the session thread isn't stuck in report() when the
            # process dies
            self._ack(trial)
            trial.state = TERMINATED
            self._stop_actor(trial)
            self._notify_searcher_complete(trial, error=False)
            if self.verbose:
                print(f"[tune] trial {trial.id} early-stopped at iter {trial.iteration}")
            self._release_held()
        elif decision == sched_mod.EXPLOIT and getattr(self.scheduler, "synch", False):
            self._held.append(trial)
            self._release_held()
        elif decision == sched_mod.EXPLOIT:
            self._exploit_or_ack(trial)
        else:
            self._ack(trial)
        self._save_experiment_state()

    def _exploit_or_ack(self, trial: Trial):
        donor = self.scheduler.choose_exploit_source(trial, self.trials)
        if donor is not None and donor.checkpoint is not None:
            self._exploit(trial, donor)
        else:
            self._ack(trial)

    def _release_held(self):
        """Synchronous PBT: once every running trial is held at the
        perturbation point, decide for each (ranked on that point's scores)."""
        if not self._held or any(t.state == RUNNING and t not in self._held for t in self.trials):
            return
        held, self._held = self._held, []
        for t in held:
            if t.state == RUNNING:
                self._exploit_or_ack(t)

    def _ack(self, trial: Trial):
        if trial.actor is not None:
            try:
                ray_tpu_torch.get(trial.actor.ack_result.remote(), timeout=10.0)
            except Exception:
                pass

    def _exploit(self, trial: Trial, donor: Trial):
        """PBT exploit+explore (reference ``pbt.py:865``): restart this trial
        from the donor's checkpoint with a perturbed copy of donor's config."""
        self._stop_actor(trial)
        new_config = dict(donor.config)
        if hasattr(self.scheduler, "perturb_config"):
            new_config = self.scheduler.perturb_config(new_config)
        trial.config = new_config
        donor_ckpt = donor.checkpoint
        if self.verbose:
            print(f"[tune] trial {trial.id} exploits {donor.id}; new config={new_config}")
        self._start_trial(trial, checkpoint=donor_ckpt)

    def _on_trial_failure(self, trial: Trial, error: BaseException):
        self._stop_actor(trial)
        if trial.retries_left != 0:
            if trial.retries_left > 0:
                trial.retries_left -= 1
            trial.state = PENDING  # relaunched from latest checkpoint
            if self.verbose:
                print(f"[tune] trial {trial.id} failed ({error}); will retry")
        else:
            trial.state = ERROR
            trial.error = error
            self._notify_searcher_complete(trial, error=True)
        if trial in self._held:
            self._held.remove(trial)
        self._save_experiment_state()
        self._release_held()

    # ------------------------------------------------------- state snapshot

    def _save_experiment_state(self, force: bool = False):
        """Experiment-state checkpoint (reference ``tune_controller.py:451``
        periodic experiment snapshots). The local JSON is cheap and written
        every call; the cloud upload is throttled unless ``force``."""
        state = {
            "timestamp": time.time(),
            "trials": [
                {
                    "id": t.id,
                    "config": _json_safe(t.config),
                    "state": t.state,
                    "last_result": _json_safe(t.last_result or {}),
                    "iteration": t.iteration,
                    "dir": t.dir,
                    "error": repr(t.error) if t.error else None,
                }
                for t in self.trials
            ],
        }
        tmp = os.path.join(self.exp_dir, ".experiment_state.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, os.path.join(self.exp_dir, "experiment_state.json"))
        if self.storage is not None and (
            force or time.monotonic() - self._last_state_upload >= 10.0
        ):
            # experiment state rides the same pyarrow.fs tier as checkpoints,
            # PERIODICALLY — a blocking cloud PUT per trial result would
            # serialize the whole control loop behind uploads (reference:
            # tune_controller.py:451 periodic cloud snapshots)
            try:
                self.storage.write_json("experiment_state.json", state)
                self._last_state_upload = time.monotonic()
            except Exception as e:  # noqa: BLE001 - storage outage must not kill the loop
                print(f"[ray_tpu_torch.tune] experiment-state upload failed: {e!r}")


from ray_tpu_torch.train._checkpoint_manager import json_safe as _json_safe  # noqa: E402
