"""One workflow through both packages: ``ray_tpu.workflow`` and
``ray_tpu_torch.workflow``, each driver a fresh process of its own, must
run alike.

The workload: prompts feed a ``generate`` step (each package's paged
engine, greedy, over the reference's narrow fp32 GPT weights on the CPU)
and a ``lengths`` step; a ``score`` step sums each continuation's logprob
under teacher forcing (each package's forward) and fails once through a
marker file; a ``MultiOutputNode`` of the three feeds ``summarize`` with
a durable event, and ``summarize`` returns a continuation of one step. The
first driver's ``run`` fails at ``score``; a second, fresh driver sends
the event and ``resume``s, then records the run in a virtual actor. Both
packages must give equal step ids for the graph, the same files under
storage, the same sequence of event types and equal tokens; the scores
agree within ``SCORE_TOL`` relative to max(1, |reference|); ``generate``
ran exactly once in each.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from ray_tpu.models.gpt import GPTConfig as RefGPTConfig
from ray_tpu.models.gpt import gpt_init as ref_gpt_init

REPO = Path(__file__).resolve().parents[1]
NARROW = dict(vocab_size=384, seq_len=40, d_model=64, n_layers=2, n_heads=4, dtype="float32")
SCORE_TOL = 1e-5

WORKLOAD = r'''
import importlib, json, os, pickle, sys
import numpy as np

pkg, storage, side, mode = sys.argv[1:5]
rt = importlib.import_module(pkg)
workflow = importlib.import_module(pkg + ".workflow")
MultiOutputNode = importlib.import_module(pkg + ".dag").MultiOutputNode
NARROW = json.loads(sys.argv[5])
if pkg == "ray_tpu":
    rt.init(num_cpus=4, num_tpus=0)
else:
    rt.init(num_cpus=4, num_gpus=0)


def load_model():
    """The package's config and weights: the reference's tree from ``side``."""
    with open(os.path.join(side, "weights.pkl"), "rb") as f:
        tree = pickle.load(f)
    gpt = importlib.import_module(pkg + ".models.gpt")
    if pkg == "ray_tpu":
        cfg = gpt.GPTConfig(**NARROW, remat=False, attn_impl="xla", fused_loss=False)
        return gpt, cfg, tree
    cfg = gpt.GPTConfig(**NARROW)
    return gpt, cfg, gpt.params_from_jax(tree, cfg, "cpu")


@rt.remote
def prompts(seed):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, NARROW["vocab_size"], n)] for n in (6, 9, 12)]


@rt.remote
def lengths(ps):
    return [len(p) for p in ps]


@rt.remote
def generate(ps):
    with open(os.path.join(side, pkg + ".generate_ran"), "a") as f:
        f.write("x")
    gpt, cfg, params = load_model()
    llm = importlib.import_module(pkg + ".llm")
    ecfg = llm.EngineConfig(max_slots=3, num_blocks=32, block_size=4, max_blocks_per_seq=12, prefill_chunk=8)
    kw = {} if pkg == "ray_tpu" else {"device": "cpu"}
    eng = llm.LLMEngine(cfg, params, ecfg, **kw)
    sp = llm.SamplingParams(max_tokens=8, temperature=0.0)
    return [[int(t) for t in eng.generate(p, sp)] for p in ps]


@rt.remote
def score(ps, toks, marker):
    if not os.path.exists(marker):
        with open(marker, "w") as f:
            f.write("x")
        raise RuntimeError("score fails once")
    gpt, cfg, params = load_model()
    out = []
    for p, t in zip(ps, toks):
        ids = np.asarray([p + t])
        if pkg == "ray_tpu":
            logits = np.asarray(gpt.gpt_forward(cfg, params, ids))
        else:
            import torch
            with torch.no_grad():
                logits = gpt.gpt_forward(cfg, params, torch.from_numpy(ids)).numpy()
        z = logits[0].astype(np.float64)
        logp = z - z.max(-1, keepdims=True)
        logp -= np.log(np.exp(logp).sum(-1, keepdims=True))
        out.append(float(sum(logp[len(p) - 1 + j, tok] for j, tok in enumerate(t))))
    return out


@rt.remote
def finish(parts, go):
    toks, scores, lens = parts
    return {"tokens": toks, "scores": scores, "lengths": lens, "go": go}


@rt.remote
def summarize(parts, go):
    return workflow.continuation(finish.bind(parts, go))


class RunLedger:
    def __init__(self):
        self.runs = []

    def record(self, wid, n):
        self.runs.append([wid, n])
        return len(self.runs)

    @workflow.readonly
    def count(self):
        return len(self.runs)


p = prompts.bind(7)
gen = generate.bind(p)
dag = summarize.bind(MultiOutputNode([gen, score.bind(p, gen, os.path.join(side, pkg + ".score_failed")),
                                      lengths.bind(p)]), workflow.wait_for_event("go"))
res = {"ids": sorted(workflow._step_ids(dag).values())}
if mode == "run":
    try:
        workflow.run(dag, workflow_id="k", storage=storage)
        res["run"] = "finished"
    except Exception as e:
        res["run"] = type(e).__name__ + ("" if "score fails once" in str(e) else ": " + str(e))
    res["status"] = workflow.get_status("k", storage)
else:
    workflow.send_event("k", "go", "now", storage=storage)
    out = workflow.resume("k", storage=storage)
    res["output"] = out
    res["again"] = workflow.resume("k", storage=storage) == out
    res["status"] = workflow.get_status("k", storage)
    ledger = workflow.virtual_actor(RunLedger).get_or_create("runs", storage=storage)
    ledger.record("k", sum(len(t) for t in out["tokens"]))
    res["ledger"] = workflow.get_actor("runs", RunLedger, storage=storage).count()
    res["list"] = workflow.list_all(storage)
    res["events"] = [e["type"] for e in workflow.get_events("k", storage)]
    res["layout"] = sorted(os.path.relpath(os.path.join(d, f), storage)
                           for d, _, fs in os.walk(storage) for f in fs)
    res["generate_ran"] = open(os.path.join(side, pkg + ".generate_ran")).read()
rt.shutdown()
print("RESULT " + json.dumps(res, sort_keys=True))
'''


def _drive(package: str, storage: Path, side: Path, mode: str) -> dict:
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", WORKLOAD, package, str(storage), str(side), mode,
                           json.dumps(NARROW)], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    side = tmp_path_factory.mktemp("side")
    cfg = RefGPTConfig(**NARROW, remat=False, attn_impl="xla", fused_loss=False)
    with open(side / "weights.pkl", "wb") as f:
        pickle.dump(jax.device_get(ref_gpt_init(jax.random.PRNGKey(0), cfg)), f)
    out = {}
    for package in ("ray_tpu", "ray_tpu_torch"):
        storage = tmp_path_factory.mktemp(package)
        run = _drive(package, storage, side, "run")
        out[package] = (run, _drive(package, storage, side, "resume"))
    return out


def test_the_run_fails_at_score_and_the_resume_finishes(results):
    for package, (run, resumed) in results.items():
        assert run["run"].startswith("RayTaskError") and run["status"] == "FAILED", package
        assert resumed["status"] == "SUCCESSFUL" and resumed["again"] is True, package
        assert resumed["output"]["go"] == "now" and resumed["output"]["lengths"] == [6, 9, 12], package
        assert [len(t) for t in resumed["output"]["tokens"]] == [8, 8, 8], package
        # the virtual actors' directory lists as a workflow with no status,
        # in both packages
        assert resumed["ledger"] == 1, package
        assert resumed["list"] == [["k", "SUCCESSFUL"], ["virtual_actors", None]], package
        assert resumed["generate_ran"] == "x", f"{package}: generate ran again on resume"


@pytest.mark.parametrize("key", ["ids", "layout", "events"])
def test_same_step_ids_files_and_events_as_the_reference(results, key):
    (ref_run, ref), (port_run, port) = results["ray_tpu"], results["ray_tpu_torch"]
    assert port[key] == ref[key]
    if key == "ids":  # the same in each driver
        assert port_run["ids"] == ref_run["ids"] == ref["ids"]


def test_same_tokens_and_scores_as_the_reference(results):
    ref, port = results["ray_tpu"][1]["output"], results["ray_tpu_torch"][1]["output"]
    assert port["tokens"] == ref["tokens"]
    gaps = [abs(p - r) / max(1.0, abs(r)) for p, r in zip(port["scores"], ref["scores"])]
    assert len(gaps) == 3 and max(gaps) <= SCORE_TOL, (port["scores"], ref["scores"])
