"""The port's CLI, ``python -m ray_tpu_torch`` (``ray_tpu_torch/scripts.py``,
``__main__.py``), in subprocesses as an operator runs it.

Mirrors ``tests/test_multihost.py::test_cli_head_node_driver_roundtrip``
(with its contention skip), and adds what the port changes or the
reference's tests leave out: ``start --head`` registers the host's cards as
``GPU`` (here ``CUDA_VISIBLE_DEVICES`` lists them) and ``--resources``
overrides it; ``status``, ``list``, ``grafana`` and ``up --ticks`` on a
``.json`` config run; a node agent leaves once its head is gone."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import ray_tpu_torch

REPO = Path(__file__).resolve().parents[1]
CLI_ENV = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
CLI_ENV.pop("RAY_TPU_AUTHKEY", None)  # the head and its clients share the default key


def cli(*args, env=None, timeout=120) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args], capture_output=True, text=True,
                          timeout=timeout, env=env or CLI_ENV)


def json_doc(stdout: str):
    """The JSON document a command printed: stray runtime prints (warnings
    may even contain braces) can precede it, so it starts at the first bare
    ``{`` line."""
    lines = stdout.splitlines()
    return json.loads("\n".join(lines[lines.index("{"):]))


def start_head(*args, env=None) -> tuple:
    """``start --head`` in a subprocess: (the process, its address)."""
    proc = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", "start", "--head", "--port", "0", *args],
                            stdout=subprocess.PIPE, text=True, env=env or CLI_ENV)
    line = proc.stdout.readline()
    assert "listening on" in line, line
    return proc, line.strip().rsplit(" ", 1)[-1]


def stop(*procs) -> None:
    for p in procs:
        if p is not None and p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def test_cli_head_node_driver_roundtrip(tmp_path):
    """The real deployment shape: `ray_tpu_torch start --head` in one process,
    `ray_tpu_torch start --address` in another, driver + state CLI attach over
    TCP.

    Capability probe (the reference's skip, kept): three cold interpreters
    boot back to back under 60s/120s budgets; when the spin canary shows the
    box contended, their boot times would measure the neighbors, not the
    control plane."""
    from conftest import SPIN_CANARY_FLOOR_MOPS, spin_mops

    canary = spin_mops()
    if canary < SPIN_CANARY_FLOOR_MOPS:
        pytest.skip(
            f"box contended (spin canary {canary:.1f} Mops < 12): three "
            "cold-interpreter boots under 60s/120s budgets measure the "
            "ambient load, not the CLI control plane"
        )
    head_proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--head", "--port", "0", "--num-cpus", "0"],
        stdout=subprocess.PIPE,
        text=True,
        env=CLI_ENV,
    )
    node_proc = None
    try:
        line = head_proc.stdout.readline()
        assert "listening on" in line, line
        address = line.strip().rsplit(" ", 1)[-1]
        node_proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "start", "--address", address,
             "--num-cpus", "2"],
            stdout=subprocess.PIPE,
            text=True,
            env=CLI_ENV,
        )
        assert "joined" in node_proc.stdout.readline()

        ray_tpu_torch.init(address=address)

        @ray_tpu_torch.remote
        def f(x):
            return x + 1

        assert ray_tpu_torch.get([f.remote(i) for i in range(4)], timeout=60) == [1, 2, 3, 4]
        ray_tpu_torch.shutdown()

        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", "summary", "--address", address],
            capture_output=True,
            text=True,
            timeout=120,
            env=CLI_ENV,
        )
        assert out.returncode == 0, out.stderr
        summ = json_doc(out.stdout)
        assert summ["tasks"]["by_state"].get("FINISHED", 0) >= 4
        assert len(summ["nodes"]) == 2
    finally:
        stop(node_proc, head_proc)


@pytest.mark.parametrize("override", [False, True], ids=["detected", "resources_override"])
def test_start_head_registers_gpus(override):
    """``start --head`` registers the host's cards as ``GPU`` where the
    reference registers TPU chips: two under ``CUDA_VISIBLE_DEVICES=0,1``;
    ``--resources '{"GPU": 0}'`` wins over the detection. ``status`` shows
    the totals; the head exits 0 on SIGTERM."""
    env = dict(CLI_ENV, CUDA_VISIBLE_DEVICES="0,1")
    extra = ["--resources", json.dumps({"GPU": 0})] if override else []
    head, address = start_head("--num-cpus", "1", *extra, env=env)
    try:
        out = cli("status", "--address", address)
        assert out.returncode == 0, out.stderr
        doc = json_doc(out.stdout)
        assert doc["cluster_resources"]["GPU"] == (0.0 if override else 2.0), doc
        assert doc["cluster_resources"]["CPU"] == 1.0
        assert len(doc["nodes"]) == 1
    finally:
        head.terminate()
        assert head.wait(timeout=30) == 0
        stop(head)


def test_status_list_and_grafana(tmp_path):
    """``status``, ``list nodes``, ``list actors`` and ``grafana -o``
    against a head with one joined node, and ``grafana`` with no cluster."""
    head, address = start_head("--num-cpus", "1")
    node = None
    try:
        node = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", "start", "--address", address,
                                 "--num-cpus", "2", "--labels", json.dumps({"provider_node_id": "p1"})],
                                stdout=subprocess.PIPE, text=True, env=CLI_ENV)
        assert "joined" in node.stdout.readline()
        out = cli("status", "--address", address)
        assert out.returncode == 0, out.stderr
        doc = json_doc(out.stdout)
        assert doc["cluster_resources"]["CPU"] == 3.0
        nodes = cli("list", "nodes", "--address", address)
        assert nodes.returncode == 0, nodes.stderr
        listed = json.loads(nodes.stdout[nodes.stdout.index("["):])
        assert sorted(n["Labels"].get("provider_node_id", "") for n in listed) == ["", "p1"], listed
        actors = cli("list", "actors", "--address", address)
        assert actors.returncode == 0 and json.loads(actors.stdout[actors.stdout.index("["):]) == []
        board = tmp_path / "board.json"
        out = cli("grafana", "-o", str(board))
        assert out.returncode == 0 and out.stdout.strip() == f"wrote {board}"
        panels = json.loads(board.read_text())["panels"]
        assert panels and all(p["targets"][0]["expr"] for p in panels)
    finally:
        head.terminate()
        assert head.wait(timeout=30) == 0
        stop(head, node)


def test_a_burst_of_connects_all_attach():
    """Clients that connect to ``start --head``'s TCP port at one instant
    (CLI commands run side by side) each finish the handshake: with a
    listen backlog of 1, some waited for the challenge for good."""
    from ray_tpu_torch._private.config import DEFAULT_AUTHKEY
    from ray_tpu_torch._private.worker_main import connect_head

    head, address = start_head("--num-cpus", "1")
    n, conns, errors = 16, [], []
    gate = threading.Barrier(n)

    def attach():
        try:
            gate.wait(timeout=30)
            conns.append(connect_head(address, DEFAULT_AUTHKEY, retries=1))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    # daemon threads: a client stuck in the handshake must not hold the
    # interpreter at exit
    threads = [threading.Thread(target=attach, daemon=True) for _ in range(n)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 20
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        stuck = sum(t.is_alive() for t in threads)
        assert not stuck, f"{stuck} of {n} clients still in the handshake after 20 s"
        assert not errors and len(conns) == n, errors
    finally:
        for c in list(conns):
            c.close()
        stop(head)


def _attaches_within(connect, seconds: float) -> tuple:
    """``connect()`` in a daemon thread (a client stuck in the handshake
    must not hold the interpreter at exit): (whether it returned within
    ``seconds``, its connection, its error)."""
    got = {}

    def run():
        try:
            got["conn"] = connect()
        except Exception as e:  # noqa: BLE001 - reported by the caller
            got["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    return not t.is_alive(), got.get("conn"), got.get("error")


def test_a_silent_client_stalls_no_connect():
    """A raw socket that connects to ``start --head``'s TCP port and sends
    nothing holds up no other client: the hmac handshake runs in each
    connection's thread under a deadline. With the handshake in the accept
    thread, that thread waited on the silent client, and every later
    driver, CLI and worker connect waited behind it, with no timeout."""
    import socket

    from ray_tpu_torch._private.config import DEFAULT_AUTHKEY
    from ray_tpu_torch._private.worker_main import connect_head

    head, address = start_head("--num-cpus", "1")
    host, port = address.rsplit(":", 1)
    silent = socket.create_connection((host, int(port)))
    conn = None
    try:
        time.sleep(0.5)  # the head has accepted the silent client
        done, conn, error = _attaches_within(lambda: connect_head(address, DEFAULT_AUTHKEY, retries=1), 5.0)
        assert done, "a connect waited 5 s behind a client that sent nothing"
        assert error is None and conn is not None, error
    finally:
        silent.close()
        if conn is not None:
            conn.close()
        stop(head)


def test_a_silent_client_stalls_no_data_plane_pull():
    """The data server's listener too: a silent socket holds up no puller."""
    import socket
    from multiprocessing.connection import Client

    from ray_tpu_torch._private.data_plane import DataServer

    key = b"k" * 32
    server = DataServer(key, "127.0.0.1")
    silent = socket.create_connection(("127.0.0.1", server.port))
    conn = None
    try:
        time.sleep(0.2)
        done, conn, error = _attaches_within(lambda: Client(("127.0.0.1", server.port), authkey=key), 5.0)
        assert done, "a pull's connect waited 5 s behind a client that sent nothing"
        assert error is None and conn is not None, error
    finally:
        silent.close()
        if conn is not None:
            conn.close()
        server.shutdown()


def test_a_client_that_stops_mid_header_is_dropped_at_the_deadline(monkeypatch):
    """The handshake's deadline covers every read, not only the first
    byte: a client that sends half of its answer's length header and stops
    is disconnected once ``HANDSHAKE_TIMEOUT_S`` has passed."""
    import socket

    from ray_tpu_torch._private import data_plane

    monkeypatch.setattr(data_plane, "HANDSHAKE_TIMEOUT_S", 0.5)
    server = data_plane.DataServer(b"k" * 32, "127.0.0.1")
    stalled = socket.create_connection(("127.0.0.1", server.port))
    try:
        stalled.settimeout(10.0)
        stalled.sendall(b"\x00\x00")
        received = b""
        while chunk := stalled.recv(4096):  # the challenge, then the end
            received += chunk
        assert received, "the server sent no challenge"
    except socket.timeout:
        raise AssertionError("a client that stopped mid-header held its connection 10 s") from None
    finally:
        stalled.close()
        server.shutdown()


def test_node_agent_leaves_when_its_head_is_gone():
    """After the head's SIGTERM the node agent exits on its own, once its
    reconnect grace (``head_reconnect_grace_s``) has run out."""
    head, address = start_head("--num-cpus", "1")
    env = dict(CLI_ENV, RAY_TPU_HEAD_RECONNECT_GRACE_S="1")
    node = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", "start", "--address", address,
                             "--num-cpus", "1"], stdout=subprocess.PIPE, text=True, env=env)
    try:
        assert "joined" in node.stdout.readline()
        head.terminate()
        assert head.wait(timeout=30) == 0
        t0 = time.monotonic()
        assert node.wait(timeout=30) == 0
        assert time.monotonic() - t0 < 20
    finally:
        stop(head, node)


def test_up_cli_json_config_in_a_subprocess(tmp_path):
    """``python -m ray_tpu_torch up cfg.json --ticks 4`` with the fake
    provider: the autoscaler buys min_workers virtual nodes, they join, and
    ``down`` terminates nothing (the fake's nodes die with its head)."""
    cfg = {"cluster_name": "t", "provider": {"type": "fake"}, "head": {"num_cpus": 1},
           "node_types": {"w": {"resources": {"CPU": 2}, "min_workers": 1, "max_workers": 2}},
           "idle_timeout_s": 60, "update_interval_s": 0}
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(cfg))
    out = cli("up", str(path), "--ticks", "4")
    assert out.returncode == 0, out.stderr
    assert "[t] head listening on" in out.stdout and "python -m ray_tpu_torch start" in out.stdout
    counts = json.loads(out.stdout.rsplit("instances: ", 1)[1].splitlines()[0])
    assert counts == {"RAY_RUNNING": 1}, counts
    down = cli("down", str(path))
    assert down.returncode == 0 and "[t] terminated 0 instance(s)" in down.stdout
