#!/usr/bin/env python3
"""Times a cut of ``chip_smoke.py``'s phases against an earlier version of
the script, in turns, on one GPU.

    python3 chip_cuts.py PARENT_DIR        # phases 7, 12 and 20
    python3 chip_cuts.py PARENT_DIR 28     # phase 28
    python3 chip_cuts.py PARENT_DIR 25     # phase 25

Loads ``PARENT_DIR/chip_smoke.py`` beside this checkout's (both drive this
checkout's ``ray_tpu_torch``) and runs each phase of the two versions in
the order parent, change, change, parent, printing each run's seconds and,
as its last line, ``CUTS`` and a JSON object of them. The profile phases:
builds the paged-attention kernels once, and on one engine each runs
phase 7 (GPT-J-6B decode profile), phase 12 (its verify profile) and phase
20 (GPT-124M's decode and verify profiles). Phase 28: builds the flash
kernels once and runs ``tune_over_train`` (three ``Tuner`` runs, each a
fresh cluster of trial processes; the phase's own checks hold in every
turn). Phase 25: builds the flash kernels, runs phase 17 (the 406M
training the phase is held against) once, then ``train_over_runtime``
(a ``TorchTrainer`` run whose worker dies and restarts from a checkpoint,
on a fresh cluster; the phase's own checks hold in every turn). Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time


def load_parent(parent_dir: str):
    path = os.path.join(os.path.abspath(parent_dir), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_parent", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_by_value(name: str, path: str):
    """``path`` as a module whose functions travel to workers by value, as
    a script's own ``__main__`` functions do when it runs: the runtime's
    serializer reserializes any payload naming ``__main__`` with
    cloudpickle, which pickles a registered module by value."""
    import cloudpickle

    spec = importlib.util.spec_from_file_location(f"{name}__main__", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    cloudpickle.register_pickle_by_value(module)
    return module


def main() -> int:
    import torch

    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ["28"], ["25"]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_cuts: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    if sys.argv[2:] in (["28"], ["25"]):  # the phase's loops run in worker processes
        cs = load_by_value("chip_smoke_change", os.path.join(here, "chip_smoke.py"))
        parent = load_by_value("chip_smoke_parent", os.path.join(os.path.abspath(sys.argv[1]), "chip_smoke.py"))
    else:
        import chip_smoke as cs

        parent = load_parent(sys.argv[1])
    cs.share_bytecode()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    times: dict = {}

    def turns(label, run_parent, run_change):
        for who, run in (("parent", run_parent), ("change", run_change), ("change", run_change),
                         ("parent", run_parent)):
            t0 = time.perf_counter()
            run()
            times.setdefault(label, {}).setdefault(who, []).append(round(time.perf_counter() - t0, 2))
            print(f"TURN phase {label} {who} {times[label][who][-1]} s", flush=True)

    if sys.argv[2:] == ["28"]:
        cs._kernels.build("flash_attention")
        turns("28", lambda: parent.tune_over_train(card), lambda: cs.tune_over_train(card))
        print(f"card: {card}")
        print("CUTS " + json.dumps(times))
        return 0
    if sys.argv[2:] == ["25"]:
        cs._kernels.build("flash_attention")
        cs.phase("17 406M training")
        trained = cs.train_406m(card)
        torch.cuda.empty_cache()
        turns("25", lambda: parent.train_over_runtime(card, trained), lambda: cs.train_over_runtime(card, trained))
        print(f"card: {card}")
        print("CUTS " + json.dumps(times))
        return 0
    for src in ("paged_attention", "paged_verify_attention"):
        cs._kernels.build(src)
    cs.phase("6 GPT-J-6B serve")
    served = cs.serve_6b(card)
    eng = served.pop("engine")
    turns("7", lambda: parent.profile_decode(eng, card), lambda: cs.profile_decode(eng, card))
    del eng
    torch.cuda.empty_cache()
    cs.phase("11 GPT-J-6B spec serve")
    spec = cs.spec_serve_6b(served.pop("params"), card)
    eng = spec.pop("engine")
    turns("12", lambda: parent.profile_verify(eng, card), lambda: cs.profile_verify(eng, card))
    del eng, spec
    torch.cuda.empty_cache()
    cs.phase("19 GPT-124M serve")
    gpt = cs.serve_gpt(card)
    decode, verify = gpt["engine"], gpt["spec_engine"]

    def profile_20(module):
        module.profile_decode(decode, card, "GPT-124M decode profile")
        module.profile_verify(verify, card, "GPT-124M verify profile")

    turns("20", lambda: profile_20(parent), lambda: profile_20(cs))
    print(f"card: {card}")
    print("CUTS " + json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
