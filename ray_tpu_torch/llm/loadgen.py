"""Open-loop load harness for the served LLM path (copy of
``ray_tpu/llm/loadgen.py``; the served app runs on the card unless the
caller asks for the CPU).

Closed-loop load tests (N workers, each waiting for its response before
sending the next) let the system set its own arrival rate — under
saturation the clients slow down WITH the server and queueing delay
hides (coordinated omission).  This harness is OPEN-LOOP: an arrival
curve fixes *when* every request fires before the run starts, each
request gets its own connection and coroutine, and a slow server just
accumulates in-flight streams — exactly what a production p99 sees.

Everything rides the REAL serving path: raw HTTP/1.1 over loopback
sockets into the asyncio proxy (chunked streaming responses, the
``x-request-id`` correlation header, ``x-deadline-s`` shed opt-in) — no
handle shortcuts, so proxy dispatch, router admission and stream
delivery are all inside the measurement.  Client-side timings (TTFT,
e2e, status) pair with the server-side phase ledgers (``util.phases``)
through the request id; ``obs.attribute_rows`` joins them into the
per-phase decomposition the report carries.

Arrival curves: ``constant`` (fixed rate), ``poisson`` (exponential
gaps — real traffic's burstiness at the same average rate), ``ramp``
(linear rate growth — find the knee), ``burst`` (quiet base rate with a
simultaneous clump — recovery behavior).

The standard report (``run_report``) drives three arms against one
served app (on ``device``: ``None`` means the card, one replica per GPU up
to two; ``"cpu"`` runs two CPU replicas): healthy (sustained rate the engine can hold), overload
(arrival rate past capacity with a declared deadline — the shed plane
answers 429 and the report shows where the SURVIVORS' latency went),
and replica-kill (a SIGKILL mid-stream — failover resume shows up as
the ``failover`` phase, never as re-counted token time).  Driver-side
arithmetic is plain-Python sorts over small lists — no device values,
no per-loop host syncs.

CLI::

    python -m ray_tpu_torch.llm.loadgen --smoke -o loadgen.json            # the card
    python -m ray_tpu_torch.llm.loadgen --smoke --device cpu -o loadgen.json
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import random
import sys
import time
from typing import Callable, Optional

#: default request shape: small prompts, short completions — the harness
#: measures the serving plane, not the model
_PROMPT_BASE = [5, 6, 7, 8] * 3
_MAX_TOKENS = 8

CURVES = ("constant", "poisson", "ramp", "burst")


# ---------------------------------------------------------------------------
# arrival curves
# ---------------------------------------------------------------------------


def arrivals(
    curve: str,
    rate: float,
    duration_s: float,
    seed: int = 0,
    ramp_to: Optional[float] = None,
    burst_n: int = 0,
) -> list[float]:
    """Offsets (seconds from arm start) at which requests fire — computed
    up front so the schedule cannot react to server behavior (the open-
    loop property lives HERE)."""
    if rate <= 0 or duration_s <= 0:
        return []
    if curve == "constant":
        n = int(rate * duration_s)
        return [i / rate for i in range(n)]
    if curve == "poisson":
        rng = random.Random(seed)
        out, t = [], 0.0
        while True:
            t += rng.expovariate(rate)
            if t >= duration_s:
                return out
            out.append(t)
    if curve == "ramp":
        # linear rate(t) = rate + (ramp_to - rate) * t/D; fire request i
        # where the cumulative count crosses i (quadratic inverse)
        r1 = ramp_to if ramp_to is not None else rate * 3.0
        total = (rate + r1) / 2.0 * duration_s
        a = (r1 - rate) / (2.0 * duration_s)
        out = []
        for i in range(int(total)):
            if abs(a) < 1e-12:
                out.append(i / rate)
            else:
                t = (-rate + math.sqrt(rate * rate + 4.0 * a * i)) / (2.0 * a)
                out.append(min(t, duration_s))
        return out
    if curve == "burst":
        base = [i / rate for i in range(int(rate * duration_s))]
        mid = duration_s / 2.0
        # the clump lands together: same offset, thousands of coroutines
        return sorted(base + [mid] * burst_n)
    raise ValueError(f"unknown curve {curve!r}; expected one of {CURVES}")


# ---------------------------------------------------------------------------
# the client (raw HTTP/1.1, streaming-aware)
# ---------------------------------------------------------------------------


async def _one_stream(
    port: int, app: str, payload: dict, deadline_s: Optional[float] = None
) -> dict:
    """One request over its own connection: send, read the streamed
    response to EOF, record status / x-request-id / TTFT / e2e."""
    rec: dict = {"t_send": time.time()}
    writer = None
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        body = json.dumps(payload).encode()
        head = (
            f"POST /{app} HTTP/1.1\r\nhost: loadgen\r\n"
            f"content-type: application/json\r\n"
            f"content-length: {len(body)}\r\nconnection: close\r\n"
        )
        if deadline_s is not None:
            head += f"x-deadline-s: {deadline_s}\r\n"
        writer.write(head.encode() + b"\r\n" + body)
        await writer.drain()
        raw_head = await reader.readuntil(b"\r\n\r\n")
        rec["status"] = int(raw_head.split(b" ", 2)[1])
        for line in raw_head.split(b"\r\n")[1:]:
            if line.lower().startswith(b"x-request-id:"):
                rec["request_id"] = line.split(b":", 1)[1].strip().decode()
        t_first = None
        while True:
            data = await reader.read(1 << 16)
            if not data:
                break
            if t_first is None:
                t_first = time.time()
        now = time.time()
        if t_first is not None and rec["status"] == 200:
            rec["ttft_s"] = round(t_first - rec["t_send"], 6)
        rec["e2e_s"] = round(now - rec["t_send"], 6)
    except Exception as e:  # noqa: BLE001 — a failed request is a data point
        rec.setdefault("status", 0)
        rec["error"] = repr(e)
        rec["e2e_s"] = round(time.time() - rec["t_send"], 6)
    finally:
        if writer is not None:
            try:
                writer.close()
            except Exception:
                pass
    return rec


async def _run_curve_async(
    port: int,
    app: str,
    offsets: list[float],
    make_payload: Callable[[int], dict],
    deadline_s: Optional[float] = None,
) -> list[dict]:
    t0 = time.time()

    async def fire(i: int, off: float) -> dict:
        delay = (t0 + off) - time.time()
        if delay > 0:
            await asyncio.sleep(delay)
        rec = await _one_stream(port, app, make_payload(i), deadline_s)
        rec["offset_s"] = round(off, 4)
        return rec

    tasks = [
        asyncio.ensure_future(fire(i, off)) for i, off in enumerate(offsets)
    ]
    return list(await asyncio.gather(*tasks))


def run_curve(
    port: int,
    app: str,
    offsets: list[float],
    make_payload: Callable[[int], dict],
    deadline_s: Optional[float] = None,
) -> list[dict]:
    """Drive one arrival curve against a served app; one record per
    request (open-loop: every request fires at its scheduled offset no
    matter how the previous ones are doing)."""
    return asyncio.run(
        _run_curve_async(port, app, offsets, make_payload, deadline_s)
    )


# ---------------------------------------------------------------------------
# client-side summaries
# ---------------------------------------------------------------------------


def _pcts(vals: list[float]) -> dict:
    vals = sorted(vals)
    n = len(vals)

    def q(p: float):
        return round(vals[min(n - 1, int(round(p * (n - 1))))], 6) if n else None

    return {"count": n, "p50": q(0.50), "p95": q(0.95), "p99": q(0.99)}


def summarize_client(records: list[dict], duration_s: float) -> dict:
    """What the CLIENTS saw: achieved rate, status mix, shed rate, and
    e2e/TTFT percentiles over the successful streams."""
    ok = [r for r in records if r.get("status") == 200]
    shed = [r for r in records if r.get("status") == 429]
    errors = [r for r in records if r.get("status") not in (200, 429)]
    return {
        "requests": len(records),
        "duration_s": round(duration_s, 3),
        "offered_rate_rps": round(len(records) / duration_s, 2)
        if duration_s > 0 else None,
        "ok": len(ok),
        "shed_429": len(shed),
        "shed_rate": round(len(shed) / len(records), 4) if records else 0.0,
        "errors": len(errors),
        "e2e_s": _pcts([r["e2e_s"] for r in ok if "e2e_s" in r]),
        "ttft_s": _pcts([r["ttft_s"] for r in ok if "ttft_s" in r]),
    }


# ---------------------------------------------------------------------------
# the standard three-arm report
# ---------------------------------------------------------------------------


def _drain_phase_events() -> list[dict]:
    """Server-side phase events drained through the head NOW — called per
    arm so a later arm's traffic can't evict an earlier arm's ledgers
    from the bounded rings.  Crash-flushed files are merged in for
    workers that died by SIGTERM; a SIGKILLed replica's ring is simply
    gone (requests it finished pre-kill lose attribution — the per-arm
    ``attributed_frac`` makes that loss visible instead of silent)."""
    from ray_tpu_torch._private import events as ev

    evs = list(ev.collect_cluster_events()) + ev.load_crash_files()
    return [
        e for e in evs if str(e.get("type", "")).startswith("llm.phase.")
    ]


def _attribution_for(evs: list[dict], rids: set, eps: float) -> dict:
    from ray_tpu_torch.obs import attribute_rows, attribution_report

    rows = [
        r for r in attribute_rows(evs) if r["request_id"] in rids
    ]
    return attribution_report(rows, top=5, eps=eps)


def _kill_active_replica_soon(delay_s: float, dep: str) -> "object":
    """Background thread: after ``delay_s``, SIGKILL the replica whose
    engine is actively generating (the chaos-suite idiom) so the arm's
    in-flight streams exercise mid-stream failover resume."""
    import signal
    import threading

    import ray_tpu_torch
    from ray_tpu_torch._private import chaos

    result: dict = {}

    def kill():
        time.sleep(delay_s)
        controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
        deadline = time.time() + 15.0
        while time.time() < deadline:
            _, replicas, _ = ray_tpu_torch.get(
                controller.get_replicas.remote(dep), timeout=10
            )
            for r in replicas:
                st = ray_tpu_torch.get(
                    r.handle_request.remote("stats", (), {}), timeout=10
                )
                if st["running"] > 0:
                    pid = chaos.pid_of_actor(r._actor_id.hex())
                    if pid is not None:
                        os.kill(pid, signal.SIGKILL)
                        result["pid"] = pid
                        return
            time.sleep(0.01)

    t = threading.Thread(target=kill, name="loadgen-killer", daemon=True)
    t.start()
    return t, result


def run_report(
    smoke: bool = False,
    kill: bool = True,
    eps: float = 0.05,
    seed: int = 0,
    device=None,
) -> dict:
    """Boot a tiny served LLM app and drive the three standard arms
    (healthy / overload / replica-kill), returning the LOADGEN report:
    client-side percentiles + server-side phase attribution per arm, and
    the overall phase-sum identity. The caller owns writing the JSON.

    ``device=None`` serves from the card: the cluster offers its GPUs and
    each replica takes one (two replicas when there are two cards, else
    one, and the kill arm then waits for the replacement); with no GPU
    ``serve.run`` raises. ``device="cpu"`` serves two CPU replicas."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.engine import EngineConfig
    from ray_tpu_torch.models.gptj import GPTJConfig
    from ray_tpu_torch.serve.llm import build_llm_app, on_card

    # phase ledgers land in bounded per-process rings; a load run emits
    # per-token events far faster than the default capacity holds
    os.environ.setdefault("RAY_TPU_EVENTS_CAPACITY", "65536")
    # fresh crash-flush dir per run unless the caller (CI) directs one —
    # stale flushes from earlier runs must not leak into attribution
    import tempfile

    os.environ.setdefault(
        "RAY_TPU_EVENTS_DIR", tempfile.mkdtemp(prefix="loadgen-events-")
    )

    tiny = GPTJConfig(
        vocab_size=128, seq_len=64, d_model=32, n_layers=2, n_heads=2,
        rotary_dim=8, dtype="float32",
    )
    ecfg = EngineConfig(
        max_slots=4, num_blocks=128, block_size=4, max_blocks_per_seq=16,
        prefill_chunk=8,
    )
    scale = 0.4 if smoke else 1.0
    t_wall = time.time()
    card = on_card(device)
    if card:
        ray_tpu_torch.init(num_cpus=8)
        replicas = int(min(2, ray_tpu_torch.cluster_resources().get("GPU", 0))) or 1
    else:
        ray_tpu_torch.init(num_cpus=8, num_gpus=0)
        replicas = 2
    report: dict = {
        "smoke": smoke,
        "eps": eps,
        "device": "cuda" if card else str(device),
        "replicas": replicas,
        "arms": {},
    }
    try:
        app = build_llm_app(
            model="gptj", model_cfg=tiny, engine_config=ecfg,
            num_replicas=replicas, max_ongoing_requests=64, device=device,
        )
        serve.run(app, name="llm", http=True, http_port=0)
        controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
        port = ray_tpu_torch.get(controller.get_proxy_port.remote(), timeout=30)

        def payload(i: int) -> dict:
            # half the fleet shares one prompt (prefix-cache hits land in
            # `admit`), half varies (real prefill)
            prompt = (
                _PROMPT_BASE
                if i % 2 == 0
                else [(i * 7 + j) % 128 for j in range(len(_PROMPT_BASE))]
            )
            return {
                "prompt": prompt,
                "max_tokens": _MAX_TOKENS,
                "temperature": 0.0,
                "seed": i,
            }

        all_rows_ok = 0
        all_rows = 0

        def run_arm(
            name: str,
            offsets: list[float],
            deadline_s: Optional[float] = None,
            overload_payload: bool = False,
            killer: Optional[float] = None,
        ) -> None:
            nonlocal all_rows, all_rows_ok
            mk = payload
            if overload_payload:
                # the engine-side shed gate reads deadline_s from the
                # payload and trips when PROMISED tokens ÷ observed service
                # rate exceeds it — so the overload arm promises long
                # completions against a deadline the backlog cannot meet
                # (the header drives the proxy capacity probe separately)
                def mk(i: int, _p=payload):
                    d = _p(i)
                    d["max_tokens"] = _MAX_TOKENS * 4
                    d["deadline_s"] = deadline_s
                    return d
            k = None
            if killer is not None:
                k = _kill_active_replica_soon(killer, "llm_LLMDeployment")
            t0 = time.time()
            recs = run_curve(port, "llm", offsets, mk, deadline_s)
            dur = time.time() - t0
            if k is not None:
                k[0].join(timeout=20.0)
            evs = _drain_phase_events()
            rids = {r["request_id"] for r in recs if r.get("request_id")}
            attr = _attribution_for(evs, rids, eps)
            client = summarize_client(recs, dur)
            arm = {
                "curve_n": len(offsets),
                "client": client,
                "attribution": attr,
                # fraction of successful streams that kept their server-side
                # ledger (a SIGKILLed replica's ring dies with it)
                "attributed_frac": round(
                    attr["n_requests"] / client["ok"], 4
                ) if client["ok"] else None,
            }
            if k is not None:
                arm["killed_pid"] = k[1].get("pid")
            report["arms"][name] = arm
            if attr["n_requests"]:
                all_rows += attr["n_requests"]
                all_rows_ok += attr["within_eps"]

        # healthy: a Poisson arrival stream the engine sustains
        run_arm(
            "healthy",
            arrivals("poisson", rate=20 * scale, duration_s=6 * scale,
                     seed=seed),
        )
        # overload: offered rate past capacity, every request declaring a
        # deadline its backlog cannot meet — the shed plane answers 429 and
        # the survivors' decomposition shows where the latency went (queue)
        run_arm(
            "overload",
            arrivals("constant", rate=80 * scale, duration_s=4 * scale),
            deadline_s=0.3,
            overload_payload=True,
        )
        if kill:
            # replica-kill: SIGKILL mid-stream; resumed requests report a
            # `failover` component instead of re-counting delivered tokens
            run_arm(
                "replica_kill",
                arrivals("constant", rate=8 * scale, duration_s=6 * scale),
                killer=1.5 * scale,
            )
        report["identity"] = {
            "eps": eps,
            "attributed_requests": all_rows,
            "within_eps": all_rows_ok,
            "within_eps_frac": (all_rows_ok / all_rows) if all_rows else None,
        }
        report["wall_s"] = round(time.time() - t_wall, 1)
        return report
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.llm.loadgen",
        description="open-loop load harness over the served LLM HTTP path",
    )
    ap.add_argument("-o", "--output", default="loadgen.json")
    ap.add_argument("--smoke", action="store_true",
                    help="scaled-down curves (CI)")
    ap.add_argument("--no-kill", action="store_true",
                    help="skip the replica-kill arm")
    ap.add_argument("--eps", type=float, default=0.05,
                    help="phase-sum identity tolerance")
    ap.add_argument("--device", default=None,
                    help="where the replicas' engines run (default: the card; "
                    "'cpu' for the CPU)")
    ap.add_argument("--assert-identity", action="store_true",
                    help="exit non-zero unless ≥99%% of attributed "
                    "requests satisfy the phase-sum identity")
    args = ap.parse_args(argv)
    report = run_report(smoke=args.smoke, kill=not args.no_kill, eps=args.eps,
                        device=args.device)
    with open(args.output, "w") as fh:
        json.dump(report, fh, indent=1, sort_keys=True)
    ident = report["identity"]
    print(
        f"loadgen: wrote {args.output} — "
        + " ".join(
            f"{name}: ok={arm['client']['ok']}/{arm['client']['requests']}"
            f" shed={arm['client']['shed_429']}"
            f" p99={arm['client']['e2e_s'].get('p99')}s"
            for name, arm in report["arms"].items()
        )
    )
    print(
        f"phase-sum identity: {ident['within_eps']}/"
        f"{ident['attributed_requests']} within ε={ident['eps']:.0%}"
    )
    if args.assert_identity:
        frac = ident["within_eps_frac"]
        if frac is None or frac < 0.99:
            print(f"IDENTITY FAILED: {frac}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
