"""The port's Serve library (``ray_tpu_torch.serve``), mirroring
``tests/test_serve.py``: deploy + handle calls, replica scaling,
composition, batching, autoscaling, HTTP ingress, replica fault tolerance,
and serving a torch model behind ``@serve.batch`` (the reference serves a
jitted JAX model there).

One cluster per module; every test ends with ``serve.shutdown()``.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


@pytest.fixture(scope="module")
def _cluster():
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def serve_instance(_cluster):
    yield
    serve.shutdown()


def test_deploy_function_and_class(serve_instance):
    @serve.deployment
    def square(x):
        return x * x

    @serve.deployment
    class Counter:
        def __init__(self):
            self.n = 0

        def __call__(self, inc):
            self.n += inc
            return self.n

    h = serve.run(square.bind(), name="fn")
    assert h.remote(7).result(timeout=30) == 49

    h2 = serve.run(Counter.bind(), name="cls")
    assert h2.remote(2).result(timeout=30) == 2
    assert h2.remote(3).result(timeout=30) == 5


def test_replicas_share_load(serve_instance):
    @serve.deployment(num_replicas=2, max_ongoing_requests=4)
    class WhoAmI:
        def __init__(self):
            import os

            self.pid = os.getpid()

        def __call__(self, _):
            time.sleep(0.05)
            return self.pid

    h = serve.run(WhoAmI.bind(), name="who")
    seen = set()
    lock = threading.Lock()

    def call(i):
        r = h.remote(i).result(timeout=60)
        with lock:
            seen.add(r)

    deadline = time.time() + 30
    while len(seen) < 2 and time.time() < deadline:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(20)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert len(seen) == 2, f"expected 2 replica pids, saw {seen}"


def test_composition_chain(serve_instance):
    @serve.deployment
    class Tokenizer:
        def __call__(self, text):
            return text.split()

    @serve.deployment
    class Len:
        def __init__(self, tok):
            self.tok = tok

        def __call__(self, text):
            return len(self.tok.remote(text).result())

    h = serve.run(Len.bind(Tokenizer.bind()), name="chain")
    assert h.remote("a b c d").result(timeout=30) == 4


def test_batching_coalesces(serve_instance):
    @serve.deployment(max_ongoing_requests=16)
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        def predict(self, xs):
            self.batch_sizes.append(len(xs))
            return [x + 1 for x in xs]

        def __call__(self, x):
            return self.predict(x)

        def sizes(self):
            return self.batch_sizes

    h = serve.run(Batched.bind(), name="batch")
    outs = []
    lock = threading.Lock()

    def call(i):
        r = h.remote(i).result(timeout=60)
        with lock:
            outs.append((i, r))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(outs) == [(i, i + 1) for i in range(16)]
    sizes = h.sizes.remote().result(timeout=30)
    assert max(sizes) > 1, f"batching never coalesced: {sizes}"


# the reference's mark (tests/test_serve.py): real autoscaler timers elapse
@pytest.mark.slow
def test_autoscaling_up_and_down(serve_instance):
    @serve.deployment(
        max_ongoing_requests=2,
        autoscaling_config=dict(
            min_replicas=1,
            max_replicas=3,
            target_ongoing_requests=1,
            upscale_delay_s=0.2,
            downscale_delay_s=0.5,
        ),
    )
    class Slow:
        def __call__(self, _):
            time.sleep(0.4)
            return 1

    h = serve.run(Slow.bind(), name="auto")
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    dep = "auto_Slow"
    assert ray_tpu_torch.get(controller.get_deployment_status.remote(dep), timeout=30)[
        "running_replicas"
    ] == 1

    stop = time.time() + 6.0
    threads = []

    def hammer():
        while time.time() < stop:
            try:
                h.remote(0).result(timeout=30)
            except Exception:
                return

    for _ in range(6):
        t = threading.Thread(target=hammer)
        t.start()
        threads.append(t)
    scaled_up = False
    while time.time() < stop:
        st = ray_tpu_torch.get(controller.get_deployment_status.remote(dep), timeout=30)
        if st["running_replicas"] > 1:
            scaled_up = True
            break
        time.sleep(0.2)
    for t in threads:
        t.join()
    assert scaled_up, "never scaled above 1 replica under load"
    deadline = time.time() + 15
    while time.time() < deadline:
        st = ray_tpu_torch.get(controller.get_deployment_status.remote(dep), timeout=30)
        if st["target_replicas"] == 1:
            break
        time.sleep(0.3)
    assert st["target_replicas"] == 1, f"never scaled down: {st}"


def test_http_ingress(serve_instance):
    @serve.deployment
    class Echo:
        def __call__(self, payload):
            return {"got": payload, "ok": True}

    serve.run(Echo.bind(), name="web", http=True, http_port=0)
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    port = ray_tpu_torch.get(controller.get_proxy_port.remote(), timeout=30)
    assert port

    def post(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/web",
            data=json.dumps({"i": i}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    out = post(1)
    assert out == {"got": {"i": 1}, "ok": True}
    results = []
    lock = threading.Lock()

    def worker(i):
        r = post(i)
        with lock:
            results.append(r["got"]["i"])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(100)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(results) == list(range(100))


def test_replica_death_recovery(serve_instance):
    @serve.deployment(num_replicas=2)
    class Sturdy:
        def __call__(self, x):
            return x + 1

    h = serve.run(Sturdy.bind(), name="sturdy")
    assert h.remote(1).result(timeout=30) == 2
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    _, replicas, _cap = ray_tpu_torch.get(
        controller.get_replicas.remote("sturdy_Sturdy"), timeout=30
    )
    ray_tpu_torch.kill(replicas[0])
    for i in range(10):
        assert h.remote(i).result(timeout=60) == i + 1
    deadline = time.time() + 20
    while time.time() < deadline:
        st = ray_tpu_torch.get(
            controller.get_deployment_status.remote("sturdy_Sturdy"), timeout=30
        )
        if st["running_replicas"] == 2:
            break
        time.sleep(0.25)
    assert st["running_replicas"] == 2


def test_serve_torch_model(serve_instance):
    """A torch model behind @serve.batch (the reference's
    ``test_serve_jax_model``): concurrent single requests coalesce into one
    batched forward, on the CPU here."""

    @serve.deployment(max_ongoing_requests=16)
    class MLP:
        def __init__(self):
            import torch

            g = torch.Generator().manual_seed(0)
            self.w1 = torch.randn(4, 32, generator=g)
            self.w2 = torch.randn(32, 2, generator=g)
            self.batches = []

        @serve.batch(max_batch_size=16, batch_wait_timeout_s=0.02)
        def predict(self, xs):
            import torch

            batch = torch.from_numpy(np.stack(xs))
            self.batches.append(len(xs))
            with torch.no_grad():
                out = torch.argmax(torch.tanh(batch @ self.w1) @ self.w2, -1)
            return [int(v) for v in out]

        def __call__(self, x):
            return self.predict(np.asarray(x, np.float32))

        def batch_sizes(self):
            return list(self.batches)

    h = serve.run(MLP.bind(), name="mlp")
    xs = [np.random.default_rng(i).normal(size=4).astype(np.float32) for i in range(12)]
    results = [None] * 12
    threads = [
        threading.Thread(target=lambda i=i: results.__setitem__(i, h.remote(xs[i].tolist()).result(timeout=60)))
        for i in range(12)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # the same MLP in this process
    import torch

    g = torch.Generator().manual_seed(0)
    w1, w2 = torch.randn(4, 32, generator=g), torch.randn(32, 2, generator=g)
    want = torch.argmax(torch.tanh(torch.from_numpy(np.stack(xs)) @ w1) @ w2, -1).tolist()
    assert results == want
    assert sum(h.batch_sizes.remote().result(timeout=30)) == 12


def test_deployment_options_and_user_config(serve_instance):
    @serve.deployment
    class Tunable:
        def __init__(self):
            self.factor = 1

        def reconfigure(self, cfg):
            self.factor = cfg["factor"]

        def __call__(self, x):
            return x * self.factor

    d = Tunable.options(num_replicas=1, user_config={"factor": 5})
    h = serve.run(d.bind(), name="tune")
    assert h.remote(3).result(timeout=30) == 15
    d2 = Tunable.options(num_replicas=1, user_config={"factor": 7})
    h = serve.run(d2.bind(), name="tune")
    deadline = time.time() + 10
    while time.time() < deadline:
        if h.remote(3).result(timeout=30) == 21:
            break
        time.sleep(0.2)
    assert h.remote(3).result(timeout=30) == 21
