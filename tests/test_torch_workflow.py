"""The port's workflows against the reference's tests: a mirror of
``tests/test_workflow.py`` run on ``ray_tpu_torch.workflow``, with no
wall-clock bar (concurrency is counted by the steps themselves instead).

Workflow durability tests (reference: ``python/ray/workflow/tests``
themes: run, checkpoint-per-step, resume-skips-done-steps, status)."""

import os

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import workflow
from ray_tpu_torch.dag import InputNode, MultiOutputNode


# The port's counterpart of the reference's ``ray_start_regular``: the tests
# need no fresh cluster, so they share one per module.
@pytest.fixture(scope="module")
def _shared_cluster():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_regular(_shared_cluster):
    yield


@pytest.fixture
def wf_storage(tmp_path, ray_start_regular):
    return str(tmp_path / "wf")


def test_run_and_output(wf_storage):
    @ray_tpu_torch.remote
    def double(x):
        return 2 * x

    @ray_tpu_torch.remote
    def inc(x):
        return x + 1

    dag = inc.bind(double.bind(5))
    out = workflow.run(dag, workflow_id="w1", storage=wf_storage)
    assert out == 11
    assert workflow.get_status("w1", wf_storage) == workflow.STATUS_SUCCESSFUL
    assert workflow.get_output("w1", wf_storage) == 11
    assert ("w1", workflow.STATUS_SUCCESSFUL) in workflow.list_all(wf_storage)


def test_input_args_flow(wf_storage):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    with InputNode() as inp:
        dag = add.bind(inp, 10)
    assert workflow.run(dag, 7, workflow_id="w2", storage=wf_storage) == 17


def test_resume_skips_completed_steps(wf_storage):
    """A step that fails once leaves earlier checkpoints; resume reruns only
    the unfinished tail."""
    marker = os.path.join(wf_storage, "fail_once")
    os.makedirs(wf_storage, exist_ok=True)
    count_file = os.path.join(wf_storage, "count")

    @ray_tpu_torch.remote
    def expensive(x):
        # count executions via a side file
        path = count_file
        n = int(open(path).read()) if os.path.exists(path) else 0
        with open(path, "w") as f:
            f.write(str(n + 1))
        return x * 10

    @ray_tpu_torch.remote
    def flaky(x, marker):
        if not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write("x")
            raise RuntimeError("transient failure")
        return x + 1

    dag = flaky.bind(expensive.bind(4), marker)
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="w3", storage=wf_storage)
    assert workflow.get_status("w3", wf_storage) == workflow.STATUS_FAILED
    assert int(open(count_file).read()) == 1  # expensive ran once

    out = workflow.resume("w3", wf_storage)
    assert out == 41
    assert int(open(count_file).read()) == 1  # NOT re-executed on resume
    assert workflow.get_status("w3", wf_storage) == workflow.STATUS_SUCCESSFUL


def test_resume_of_finished_workflow_returns_output(wf_storage):
    @ray_tpu_torch.remote
    def one():
        return 1

    workflow.run(one.bind(), workflow_id="w4", storage=wf_storage)
    assert workflow.resume("w4", wf_storage) == 1


def test_multi_output_workflow(wf_storage):
    @ray_tpu_torch.remote
    def sq(x):
        return x * x

    dag = MultiOutputNode([sq.bind(2), sq.bind(3)])
    assert workflow.run(dag, workflow_id="w5", storage=wf_storage) == [4, 9]


def test_branches_run_concurrently(ray_start_regular, tmp_path):
    """Independent branches must overlap (reference: the workflow
    executor's in-flight task set, not a sequential topological walk). Each
    branch marks its start and waits to see the other two start: run one at
    a time, the first would see only itself."""
    import time

    starts = tmp_path / "starts"
    starts.mkdir()

    @ray_tpu_torch.remote
    def slow(tag):
        (starts / tag).touch()
        deadline = time.monotonic() + 60
        while len(os.listdir(starts)) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        return tag, len(os.listdir(starts))

    @ray_tpu_torch.remote
    def join(a, b, c):
        return [a, b, c]

    dag = join.bind(slow.bind("a"), slow.bind("b"), slow.bind("c"))
    out = workflow.run(dag, workflow_id="wf_conc", storage=str(tmp_path))
    assert [tag for tag, _ in out] == ["a", "b", "c"]
    assert [seen for _, seen in out] == [3, 3, 3], f"branches ran sequentially: {out}"


def test_step_retries_via_task_options(ray_start_regular, tmp_path):
    """A step's retry budget is its task max_retries: a step that fails
    twice then succeeds completes the workflow without a resume."""
    marker = tmp_path / "attempts"

    @ray_tpu_torch.remote(max_retries=3)
    def flaky():
        n = int(marker.read_text()) if marker.exists() else 0
        marker.write_text(str(n + 1))
        if n < 2:
            raise RuntimeError(f"boom {n}")
        return "recovered"

    out = workflow.run(flaky.bind(), workflow_id="wf_retry", storage=str(tmp_path), max_step_retries=3)
    assert out == "recovered"
    assert int(marker.read_text()) == 3


def test_events_logged_and_pushed(ray_start_regular, tmp_path):
    @ray_tpu_torch.remote
    def stepa():
        return 1

    @ray_tpu_torch.remote
    def stepb(x):
        return x + 1

    live = []
    out = workflow.run(
        stepb.bind(stepa.bind()),
        workflow_id="wf_events",
        storage=str(tmp_path),
        on_event=live.append,
    )
    assert out == 2
    events = workflow.get_events("wf_events", storage=str(tmp_path))
    types = [(e["type"], e["step_id"].split("_")[1]) for e in events]
    assert ("step_started", "stepa") in types
    assert ("step_completed", "stepa") in types
    assert ("step_completed", "stepb") in types
    assert [e["type"] for e in live] == [e["type"] for e in events]
    assert all("time" in e for e in events)


# ---------------------------------------------------------------------------
# the port's own: tensors in checkpoints


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensor_survives_a_checkpoint_and_a_resume(ray_start_regular, tmp_path, dtype):
    """A step's CPU tensor (bf16 included) is checkpointed with the object
    plane's tensor reduction and comes back on the CPU, bit for bit, from
    the step file and through ``resume`` into the step that consumes it."""
    marker = tmp_path / "fail_once"
    ran = tmp_path / "ran"
    want = torch.from_numpy(np.random.RandomState(0).randn(3, 5).astype(np.float32)).to(dtype)

    @ray_tpu_torch.remote
    def make():
        with open(ran, "a") as f:
            f.write("x")
        return {"t": want.clone(), "view": want[:, 1:3]}

    @ray_tpu_torch.remote
    def consume(d):
        if not marker.exists():
            marker.touch()
            raise RuntimeError("transient failure")
        return d["t"] * 2, d["view"]

    storage = str(tmp_path / "wf")
    with pytest.raises(Exception, match="transient"):
        workflow.run(consume.bind(make.bind()), workflow_id="tensor", storage=storage)
    store = workflow._Store(storage, "tensor")
    saved = store.load_step(next(s for s in os.listdir(os.path.join(store.dir, "steps"))
                                 if "make" in s)[: -len(".pkl")])
    assert saved["t"].device.type == "cpu" and saved["t"].dtype == dtype
    assert torch.equal(saved["t"], want) and torch.equal(saved["view"], want[:, 1:3])
    doubled, view = workflow.resume("tensor", storage=storage)
    assert ran.read_text() == "x"  # make ran once: resume loaded its checkpoint
    assert doubled.device.type == "cpu" and doubled.dtype == dtype
    assert torch.equal(doubled, want * 2) and torch.equal(view, want[:, 1:3])
    assert torch.equal(workflow.get_output("tensor", storage)[0], want * 2)


# ---------------------------------------------------------------------------
# the port's own: a driver killed mid-workflow, resumed by a fresh driver

_DRIVER = r'''
import os, sys
import ray_tpu_torch
from ray_tpu_torch import workflow

storage, mode = sys.argv[1], sys.argv[2]
ray_tpu_torch.init(num_cpus=2, num_gpus=0)
if mode == "run":
    @ray_tpu_torch.remote
    def first():
        with open(os.path.join(storage, "first_ran"), "a") as f:
            f.write("x")
        return 20

    @ray_tpu_torch.remote
    def second(x, go):
        return x + go

    workflow.run(second.bind(first.bind(), workflow.wait_for_event("go")), workflow_id="k", storage=storage)
else:
    print("OUT", workflow.resume("k", storage=storage))
ray_tpu_torch.shutdown()
'''


def _session_pids(sid: int) -> list:
    pids = []
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                if os.getsid(int(name)) == sid:
                    pids.append(int(name))
            except OSError:
                pass  # exited while listed
    return pids


def test_killed_driver_leaves_no_worker_and_a_fresh_driver_resumes(tmp_path):
    """The driver owning the in-process head is SIGKILLed once the first
    step's commit is in the log, while its event step's worker waits: every
    process of its session is gone within seconds (the worker does not wait
    out its task), the status still reads RUNNING, and a fresh driver's
    ``resume`` runs no committed step again. The steps are ``__main__``
    functions of the dead driver: the graph carries them by value."""
    import signal
    import subprocess
    import sys
    import time

    storage = str(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))}
    driver = subprocess.Popen([sys.executable, "-c", _DRIVER, storage, "run"], env=env, start_new_session=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while not any(e["type"] == "step_completed" for e in workflow.get_events("k", storage)):
            assert driver.poll() is None and time.monotonic() < deadline, driver.stdout.read().decode()[-3000:]
            time.sleep(0.05)
        assert len(_session_pids(driver.pid)) > 1  # the head's template and workers are up
        os.kill(driver.pid, signal.SIGKILL)
        driver.wait(timeout=30)
        killed_at = time.time()
        deadline = time.monotonic() + 20
        while _session_pids(driver.pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _session_pids(driver.pid) == [], "processes of the killed driver outlived it"
    finally:
        for pid in _session_pids(driver.pid):
            os.kill(pid, signal.SIGKILL)
    assert workflow.get_status("k", storage) == workflow.STATUS_RUNNING
    done = [e["step_id"] for e in workflow.get_events("k", storage) if e["type"] == "step_completed"]
    assert [s.split("_")[1] for s in done] == ["first"]

    workflow.send_event("k", "go", 22, storage=storage)
    for _ in range(2):  # the second resume returns the stored output
        proc = subprocess.run([sys.executable, "-c", _DRIVER, storage, "resume"], env=env, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        assert "OUT 42" in proc.stdout.splitlines()
    after = [e for e in workflow.get_events("k", storage) if e["time"] > killed_at]
    assert [(e["type"], e["step_id"].split("_")[1]) for e in after] == [
        ("step_started", "EventNode"), ("step_started", "second"), ("step_completed", "EventNode"),
        ("step_completed", "second")]
    assert (tmp_path / "first_ran").read_text() == "x"
    assert workflow.get_status("k", storage) == workflow.STATUS_SUCCESSFUL
    assert workflow.get_output("k", storage) == 42
