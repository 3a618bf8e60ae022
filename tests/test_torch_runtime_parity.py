"""One workload through both runtimes: ``ray_tpu`` and ``ray_tpu_torch``,
each in a fresh process of its own, must give the same results.

The workload covers numpy tasks, chained and nested tasks, actors (named,
threaded, killed), ``wait``, ``put``/``get``, errors from tasks and
actors, cancellation, placement groups, streaming generators and the
resource views. The views must match apart from the accelerator keys
(``TPU``, ``GPU`` and their types), which each package detects on its own.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

WORKLOAD = r'''
import importlib, json, sys, time
import numpy as np

rt = importlib.import_module(sys.argv[1])
from importlib import import_module
pg_mod = import_module(sys.argv[1] + ".util.placement_group")
strat = import_module(sys.argv[1] + ".util.scheduling_strategies")
rt.init(num_cpus=3, num_gpus=0, num_tpus=0)
out = {}

def accel(k):
    return k.startswith(("TPU", "GPU"))

def views():
    return ({k: v for k, v in rt.cluster_resources().items() if not accel(k)},
            {k: v for k, v in rt.available_resources().items() if not accel(k)})

def settle():
    deadline = time.monotonic() + 30
    total, avail = views()
    while avail != total and time.monotonic() < deadline:
        time.sleep(0.05)
        total, avail = views()
    return total, avail

@rt.remote
def square(x):
    return x * x

@rt.remote
def np_stats(a):
    return float(a.sum()), a.dtype.str, list(a.shape), a.flags["C_CONTIGUOUS"]

@rt.remote
def add(a, b):
    return a + b

@rt.remote
def fan_out(n):
    return sum(rt.get([square.remote(i) for i in range(n)]))

out["tasks"] = rt.get([square.remote(i) for i in range(12)])
arr = np.arange(300_000, dtype=np.float32).reshape(600, 500)
out["numpy_task"] = rt.get(np_stats.remote(arr))
big = rt.put(arr)
back = rt.get(big)
out["put_get"] = [float(back.sum()), back.dtype.str, list(back.shape), bool((back == arr).all())]
out["chain"] = rt.get(add.remote(add.remote(1, 2), square.remote(3)))
out["nested"] = rt.get(fan_out.remote(6))
out["ref_in_list"] = rt.get(rt.remote(lambda refs: rt.get(refs[0]) * 2).remote([square.remote(7)]))

@rt.remote
class Counter:
    def __init__(self, start):
        self.v = start
    def inc(self, by=1):
        self.v += by
        return self.v
    def fail(self):
        raise KeyError("no such key")

c = Counter.options(name="counter").remote(10)
out["actor"] = rt.get([c.inc.remote() for _ in range(5)])
out["named"] = rt.get(rt.get_actor("counter").inc.remote(100))
try:
    rt.get(c.fail.remote())
except Exception as e:
    out["actor_error"] = [isinstance(e, KeyError), "no such key" in str(e)]
out["actor_after_error"] = rt.get(c.inc.remote())
rt.kill(c)
try:
    rt.get(c.inc.remote(), timeout=30)
    out["killed"] = "answered"
except Exception as e:
    out["killed"] = [type(e).__name__, isinstance(e, rt.exceptions.RayActorError)]

@rt.remote
def boom(x):
    raise ValueError(f"bad input {x}")

try:
    rt.get(boom.remote(3))
except Exception as e:
    out["task_error"] = [isinstance(e, ValueError), isinstance(e, rt.exceptions.RayTaskError), "bad input 3" in str(e)]
try:
    rt.get(add.remote(boom.remote(4), 1))
    out["dep_error"] = "answered"
except Exception as e:
    out["dep_error"] = [isinstance(e, ValueError), "bad input 4" in str(e)]

@rt.remote
def nap(t):
    time.sleep(t)
    return t

refs = [nap.remote(0.0), nap.remote(0.0), nap.remote(60.0)]
ready, not_ready = rt.wait(refs, num_returns=2, timeout=30)
out["wait"] = [len(ready), len(not_ready), sorted(rt.get(ready))]
rt.cancel(refs[2], force=True)
try:
    rt.get(refs[2], timeout=30)
    out["cancel"] = "answered"
except Exception as e:
    out["cancel"] = [isinstance(e, (rt.exceptions.TaskCancelledError, rt.exceptions.WorkerCrashedError, rt.exceptions.RayError))]
try:
    rt.get(nap.remote(5.0), timeout=0.2)
    out["get_timeout"] = "answered"
except Exception as e:
    out["get_timeout"] = [isinstance(e, rt.exceptions.GetTimeoutError)]

@rt.remote(num_returns="streaming")
def stream(n):
    for i in range(n):
        yield i * 3

out["stream"] = [rt.get(r) for r in stream.remote(5)]

pg = pg_mod.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
rt.get(pg.ready(), timeout=30)
out["pg"] = rt.get([square.options(scheduling_strategy=strat.PlacementGroupSchedulingStrategy(
    placement_group=pg, placement_group_bundle_index=i)).remote(i + 2) for i in range(2)])
pg_mod.remove_placement_group(pg)

total, avail = settle()
out["cluster_resources"] = total
out["available_resources"] = avail
out["nodes"] = [[n["Alive"], {k: v for k, v in n["Resources"].items() if not accel(k)}] for n in rt.nodes()]
rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True))
'''


def _run(package: str) -> dict:
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", WORKLOAD, package], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def results():
    return _run("ray_tpu"), _run("ray_tpu_torch")


SECTIONS = [
    "tasks", "numpy_task", "put_get", "chain", "nested", "ref_in_list", "actor", "named",
    "actor_error", "actor_after_error", "killed", "task_error", "dep_error", "wait", "cancel",
    "get_timeout", "stream", "pg", "cluster_resources", "available_resources", "nodes",
]


@pytest.mark.parametrize("section", SECTIONS)
def test_same_results_as_the_reference_runtime(results, section):
    ref, port = results
    assert section in ref and section in port
    assert port[section] == ref[section]


def test_the_workload_checked_what_it_meant_to(results):
    """The reference's own answers are the expected ones (so agreement is
    not agreement on a failure)."""
    ref, _ = results
    assert ref["tasks"] == [i * i for i in range(12)]
    assert ref["chain"] == 12 and ref["nested"] == 55 and ref["ref_in_list"] == 98
    assert ref["actor"] == [11, 12, 13, 14, 15] and ref["named"] == 115 and ref["actor_after_error"] == 116
    assert ref["actor_error"] == [True, True] and ref["task_error"] == [True, True, True]
    assert ref["killed"][1] is True and ref["wait"] == [2, 1, [0.0, 0.0]]
    assert ref["stream"] == [0, 3, 6, 9, 12] and ref["pg"] == [4, 9]
    assert ref["cluster_resources"]["CPU"] == 3.0
    assert ref["available_resources"] == ref["cluster_resources"]
