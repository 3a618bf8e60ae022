"""Runtime environments: env_vars, working_dir, py_modules, pip, conda,
container + plugins.

Reference: ``python/ray/_private/runtime_env/`` — ``packaging.py`` (zipped
URIs through the GCS KV, extracted per node with a URI cache), ``pip.py``
(per-env-hash virtualenv built once per node), ``plugin.py`` (the plugin
API third-party env features hang off). TPU-first simplifications:

* no per-node agent daemon — the submitting process zips/uploads
  content-addressed blobs into the head KV once; workers materialize them
  lazily into per-hash cache directories shared by every worker on the
  node (concurrent builders serialize on an fcntl lock);
* ``pip`` environments install into a per-hash PREFIX
  (``pip install --target``) activated by sys.path injection rather than
  exec'ing a venv interpreter: this image's base interpreter is itself a
  venv, so a child venv cannot chain ``--system-site-packages`` to reach
  jax/ray_tpu_torch. The activation point (marked "pip ACTIVATION SEAM" inside
  :func:`applied`) is where an exec-based implementation would slot in.
  Requirements that name LOCAL files (wheels) are shipped through the KV,
  so air-gapped clusters install with ``--no-index``;
* ``conda`` (reference ``runtime_env/conda.py``): yml specs build a
  per-content-hash prefix env once per node (``conda env create -p``);
  named envs resolve against the node's installation. Activation is
  in-process (PATH/CONDA_PREFIX + site-packages injection when the
  interpreter minor version matches) — the "conda ACTIVATION SEAM" in
  :func:`applied` is where an exec-based worker swap would slot in;
* ``container`` (reference ``runtime_env/container.py``): actors (which
  own a dedicated worker process) spawn inside ``podman run`` joining the
  host's network/IPC/PID namespaces with /tmp, /dev/shm, and the package
  root bound — see :func:`container_wrap`, applied in
  ``head._spawn_worker`` and ``node_agent._spawn``. Pooled task workers
  reject the key at submission;
* plugins: :func:`register_plugin` adds a key handled by a
  :class:`RuntimeEnvPlugin` — ``package_value`` runs at submission (upload
  side-channel data through ``ctx``), ``apply`` is a worker-side context
  manager.

``env_vars`` apply for the duration of a task (and for an actor's whole
life, since actors own their worker process). Unknown non-plugin keys
raise at submission (fail fast, like the reference's validation).
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import os
import subprocess
import sys
import tempfile
import zipfile
from typing import Any, Optional

_ALLOWED = {"env_vars", "working_dir", "py_modules", "pip", "conda", "container"}
_KV_PREFIX = "__runtime_env_pkg__/"
_EXTRACT_CACHE: dict[str, str] = {}  # kv key -> extracted dir (per process)


class RuntimeEnvPlugin:
    """Third-party runtime_env feature (reference: runtime_env/plugin.py).

    Subclass, then ``register_plugin("mykey", MyPlugin())`` — tasks/actors
    may then pass ``runtime_env={"mykey": value}``.
    """

    def package_value(self, value, ctx):
        """Submission-side: validate/normalize; may upload blobs via
        ``ctx.call("kv_put", ...)``. The return value ships in the spec."""
        return value

    @contextlib.contextmanager
    def apply(self, value, ctx):
        """Worker-side: set up around the task (or actor lifetime)."""
        yield


_PLUGINS: dict[str, RuntimeEnvPlugin] = {}

#: raylint RL017 — plugin registration is an import-time dict store on the
#: driver; worker task bodies only READ it (dict get is GIL-atomic), and a
#: registration racing a running task is a caller error by contract
LOCKFREE = ("_PLUGINS: atomic",)


def register_plugin(key: str, plugin: RuntimeEnvPlugin) -> None:
    if key in _ALLOWED:
        raise ValueError(f"{key!r} is a built-in runtime_env key")
    _PLUGINS[key] = plugin


def package(runtime_env: Optional[dict], ctx, kind: str = "task") -> Optional[dict]:
    """Validate + normalize at submission: working_dir is zipped into the
    head KV (content-addressed, uploaded once). ``kind`` is "task" or
    "actor" — container isolation needs a dedicated worker process, which
    only actors (and job supervisors) own."""
    if not runtime_env:
        return None
    unknown = set(runtime_env) - _ALLOWED - set(_PLUGINS)
    if unknown:
        raise ValueError(
            f"Unsupported runtime_env key(s) {sorted(unknown)}; "
            f"supported: {sorted(_ALLOWED | set(_PLUGINS))}"
        )
    out: dict[str, Any] = {}
    env_vars = runtime_env.get("env_vars")
    if env_vars:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in env_vars.items()):
            raise TypeError("runtime_env['env_vars'] must be a dict[str, str]")
        out["env_vars"] = dict(env_vars)
    wd = runtime_env.get("working_dir")
    if wd:
        if not os.path.isdir(wd):
            raise ValueError(f"runtime_env['working_dir'] {wd!r} is not a directory")
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            for root, _dirs, files in os.walk(wd):
                for name in files:
                    full = os.path.join(root, name)
                    zf.write(full, os.path.relpath(full, wd))
        out["working_dir_key"] = _kv_put_blob(buf.getvalue(), ctx)
    mods = runtime_env.get("py_modules")
    if mods:
        keys = []
        for mod in mods:
            if not os.path.exists(mod):
                raise ValueError(f"runtime_env['py_modules'] entry {mod!r} not found")
            keys.append(_upload_module(mod, ctx))
        out["py_modules_keys"] = keys
    reqs = runtime_env.get("pip")
    if reqs:
        if isinstance(reqs, str):
            # the string form names a requirements FILE (reference pip.py
            # semantics), expanded at submission
            if not os.path.isfile(reqs):
                raise ValueError(f"runtime_env['pip'] requirements file {reqs!r} not found")
            with open(reqs) as fh:
                reqs = [
                    line.strip()
                    for line in fh.read().splitlines()
                    if line.strip() and not line.strip().startswith("#")
                ]
        shipped = []
        for r in reqs:
            remote_form = "://" in r or r.startswith("git+") or " @ " in r
            looks_local = not remote_form and (
                "/" in r or r.endswith((".whl", ".tar.gz", ".zip"))
            )
            if looks_local and not os.path.isfile(r):
                # fail at SUBMISSION like working_dir/py_modules do, not
                # minutes later on every worker (or worse, let a connected
                # pip try to resolve the path against an index)
                raise ValueError(f"runtime_env['pip'] local distribution {r!r} not found")
            if looks_local:
                # a LOCAL distribution (wheel/sdist): ship its bytes so
                # every node can install it without an index (air-gapped)
                with open(r, "rb") as fh:
                    blob = fh.read()
                shipped.append({
                    "file_key": _kv_put_blob(blob, ctx),
                    "name": os.path.basename(r),
                })
            else:
                shipped.append({"req": r})
        out["pip"] = shipped
    conda = runtime_env.get("conda")
    if conda:
        # reference conda.py semantics: a dict is an environment.yml spec,
        # a string is either a yml FILE path or the NAME of a pre-existing
        # env on the nodes. yml content ships in the spec (it is tiny) so
        # workers need no submission-host filesystem access.
        if isinstance(conda, dict):
            import yaml as _yaml

            out["conda"] = {"yaml": _yaml.safe_dump(conda, sort_keys=True)}
        elif isinstance(conda, str) and conda.endswith((".yml", ".yaml")):
            if not os.path.isfile(conda):
                raise ValueError(f"runtime_env['conda'] file {conda!r} not found")
            with open(conda) as f:
                out["conda"] = {"yaml": f.read()}
        elif isinstance(conda, str):
            out["conda"] = {"name": conda}
        else:
            raise TypeError("runtime_env['conda'] must be a dict, yml path, or env name")
    container = runtime_env.get("container")
    if container:
        if kind != "actor":
            # a pooled task worker cannot be retroactively containerized;
            # the reference's worker-level container support likewise rides
            # dedicated worker startup (runtime_env/container.py)
            raise ValueError(
                "runtime_env['container'] requires a dedicated worker "
                "process — use an actor (or submit a job)"
            )
        if not isinstance(container, dict) or not container.get("image"):
            raise TypeError("runtime_env['container'] must be {'image': ..., ...}")
        unknown_c = set(container) - {"image", "run_options", "worker_python", "runner"}
        if unknown_c:
            raise ValueError(f"unsupported container key(s) {sorted(unknown_c)}")
        out["container"] = {
            "image": str(container["image"]),
            "run_options": [str(o) for o in container.get("run_options") or []],
            "worker_python": str(container.get("worker_python") or "python3"),
            **({"runner": str(container["runner"])} if container.get("runner") else {}),
        }
    for key, plugin in _PLUGINS.items():
        if key in runtime_env:
            out.setdefault("plugins", {})[key] = plugin.package_value(
                runtime_env[key], ctx
            )
    return out or None


def _kv_put_blob(blob: bytes, ctx) -> str:
    """Content-addressed upload-once into the cluster KV."""
    key = _KV_PREFIX + hashlib.sha1(blob).hexdigest()
    if ctx.call("kv_get", key=key) is None:
        ctx.call("kv_put", key=key, value=blob)
    return key


def _upload_module(path: str, ctx) -> dict:
    """Zip one py_modules entry so its TOP-LEVEL name lands importable
    (reference: py_modules upload in packaging.py)."""
    path = os.path.abspath(path)
    base = os.path.basename(path.rstrip("/"))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isdir(path):
            for root, _dirs, files in os.walk(path):
                for name in files:
                    full = os.path.join(root, name)
                    zf.write(full, os.path.join(base, os.path.relpath(full, path)))
        else:
            zf.write(path, base)
    return {"key": _kv_put_blob(buf.getvalue(), ctx), "name": base}


def _extract(key: str, ctx) -> str:
    path = _EXTRACT_CACHE.get(key)
    if path is not None and os.path.isdir(path):
        return path
    blob = ctx.call("kv_get", key=key)
    if blob is None:
        raise RuntimeError(f"runtime_env package {key!r} missing from cluster KV")
    path = os.path.join(
        tempfile.gettempdir(), f"ray_tpu_env_{key.rsplit('/', 1)[-1][:16]}"
    )
    if not os.path.isdir(path):
        tmp = path + f".tmp{os.getpid()}"
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            zf.extractall(tmp)
        try:
            os.replace(tmp, path)  # atomic vs concurrent extractors
        except OSError:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    _EXTRACT_CACHE[key] = path
    return path


def _cache_root() -> str:
    d = os.path.join(tempfile.gettempdir(), "ray_tpu_runtime_env")
    os.makedirs(d, exist_ok=True)
    return d


@contextlib.contextmanager
def _build_lock(name: str):
    """Cross-process build serialization (several workers on a node may
    need the same env at once — exactly one builds, the rest wait)."""
    import fcntl

    lock_path = os.path.join(_cache_root(), name + ".lock")
    with open(lock_path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def ensure_pip_prefix(shipped: list, ctx) -> str:
    """Materialize the pip environment for this node (reference: pip.py —
    per-env-hash virtualenv built once, cached by hash). Returns the
    installed prefix directory; built exactly once per node per hash (the
    ``.done`` marker is the cache hit)."""
    env_hash = hashlib.sha1(
        repr(sorted(e.get("req") or e["file_key"] for e in shipped)).encode()
    ).hexdigest()[:16]
    prefix = os.path.join(_cache_root(), f"pip-{env_hash}")
    done = os.path.join(prefix, ".done")
    if os.path.exists(done):
        return prefix
    with _build_lock(f"pip-{env_hash}"):
        if os.path.exists(done):
            return prefix  # another worker built it while we waited
        import shutil

        # build into a scratch dir, promote atomically: a failed/timed-out
        # install must never leave a half-written prefix that a retry's
        # pip (which does NOT replace existing --target dirs) then seals
        # behind a .done marker
        scratch = prefix + ".building"
        shutil.rmtree(scratch, ignore_errors=True)
        shutil.rmtree(prefix, ignore_errors=True)
        os.makedirs(scratch)
        args = []
        all_local = True
        for e in shipped:
            if "file_key" in e:
                blob = ctx.call("kv_get", key=e["file_key"])
                if blob is None:
                    raise RuntimeError(f"pip distribution {e['name']} missing from KV")
                dist = os.path.join(scratch, e["name"])
                with open(dist, "wb") as f:
                    f.write(blob)
                args.append(dist)
            else:
                args.append(e["req"])
                all_local = False
        cmd = [sys.executable, "-m", "pip", "install", "--target", scratch,
               "--no-warn-script-location", "--quiet"]
        if all_local:
            cmd.append("--no-index")  # air-gapped: everything shipped via KV
        try:
            proc = subprocess.run(cmd + args, capture_output=True, text=True, timeout=600)
        except subprocess.TimeoutExpired as e:
            shutil.rmtree(scratch, ignore_errors=True)
            raise RuntimeError(f"runtime_env pip install timed out: {e}") from None
        if proc.returncode != 0:
            shutil.rmtree(scratch, ignore_errors=True)
            raise RuntimeError(
                f"runtime_env pip install failed (rc={proc.returncode}):\n"
                f"{proc.stderr[-2000:]}"
            )
        for e in shipped:  # the wheels' CONTENTS are installed; drop the
            if "file_key" in e:  # shipped copies from the sys.path prefix
                try:
                    os.unlink(os.path.join(scratch, e["name"]))
                except OSError:
                    pass
        with open(os.path.join(scratch, ".done"), "w") as f:
            f.write("ok")
        os.rename(scratch, prefix)
    return prefix


# named env -> resolved prefix, per worker process: pooled workers apply
# envs per TASK, and a conda subprocess per task would dominate latency
_NAMED_CONDA_CACHE: dict[str, str] = {}


def _conda_exe() -> Optional[str]:
    import shutil

    return (
        os.environ.get("RAY_TPU_CONDA_EXE")
        or os.environ.get("CONDA_EXE")
        or shutil.which("conda")
        or shutil.which("mamba")
        or shutil.which("micromamba")
    )


def ensure_conda_prefix(spec: dict) -> str:
    """Materialize the conda environment for this node (reference: conda.py
    ``get_or_create_conda_env`` — per-yml-hash env built once, cached).
    Named envs resolve against the node's conda installation; yml specs
    create a prefix env under the runtime-env cache, exactly once per node
    per content hash."""
    import json
    import shutil
    import subprocess as sp

    exe = _conda_exe()
    if exe is None:
        raise RuntimeError(
            "runtime_env['conda'] requires a conda/mamba binary on the node "
            "(set RAY_TPU_CONDA_EXE to override discovery)"
        )
    name = spec.get("name")
    if name:
        cached = _NAMED_CONDA_CACHE.get(name)
        if cached is not None:
            return cached
        if name == "base":
            # the root prefix's basename is the install dir ('miniconda3'),
            # never 'base' — resolve it like the reference conda.py does
            proc = sp.run([exe, "info", "--json"], capture_output=True, text=True, timeout=120)
            if proc.returncode != 0:
                raise RuntimeError(f"conda info failed:\n{proc.stderr[-1000:]}")
            root = json.loads(proc.stdout).get("root_prefix")
            if root:
                _NAMED_CONDA_CACHE[name] = root
                return root
        proc = sp.run([exe, "env", "list", "--json"], capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"conda env list failed:\n{proc.stderr[-1000:]}")
        for prefix in json.loads(proc.stdout).get("envs", []):
            if os.path.basename(prefix) == name:
                _NAMED_CONDA_CACHE[name] = prefix
                return prefix
        raise RuntimeError(f"conda env {name!r} not found on this node")
    yml = spec["yaml"]
    env_hash = hashlib.sha1(yml.encode()).hexdigest()[:16]
    prefix = os.path.join(_cache_root(), f"conda-{env_hash}")
    done = os.path.join(prefix, ".done")
    if os.path.exists(done):
        return prefix
    with _build_lock(f"conda-{env_hash}"):
        if os.path.exists(done):
            return prefix  # another worker built it while we waited
        scratch = prefix + ".building"
        shutil.rmtree(scratch, ignore_errors=True)
        shutil.rmtree(prefix, ignore_errors=True)
        yml_path = os.path.join(_cache_root(), f"conda-{env_hash}.yml")
        with open(yml_path, "w") as f:
            f.write(yml)
        try:
            proc = sp.run(
                [exe, "env", "create", "-p", scratch, "-f", yml_path, "-q"],
                capture_output=True,
                text=True,
                timeout=900,
            )
        except sp.TimeoutExpired as e:
            shutil.rmtree(scratch, ignore_errors=True)
            raise RuntimeError(f"conda env create timed out: {e}") from None
        if proc.returncode != 0:
            shutil.rmtree(scratch, ignore_errors=True)
            raise RuntimeError(
                f"conda env create failed (rc={proc.returncode}):\n{proc.stderr[-2000:]}"
            )
        with open(os.path.join(scratch, ".done"), "w") as f:
            f.write("ok")
        os.rename(scratch, prefix)
    return prefix


def container_wrap(argv: list, env: dict, pkg_root: str, spec: dict) -> tuple[list, dict]:
    """Wrap a worker spawn command in a container runner invocation
    (reference: runtime_env/container.py — podman run with host namespaces).

    The worker must still reach the head's AF_UNIX socket (/tmp), the shm
    arena (/dev/shm), and the ray_tpu_torch package (ro bind of pkg_root), so the
    container joins the host's network/IPC/PID namespaces and binds those
    paths. ``argv`` must start with the host python; it is swapped for the
    image's ``worker_python``. RAY_TPU_*/PYTHONPATH env vars cross the
    boundary as explicit --env flags (a container does not inherit the
    spawner's environ). Returns (wrapped_argv, spawn_env)."""
    runner = (
        spec.get("runner")
        or os.environ.get("RAY_TPU_CONTAINER_RUNNER")
        or "podman"
    )
    tmp = tempfile.gettempdir()  # head socket + env caches follow TMPDIR
    prefix = [
        runner,
        "run",
        "--rm",
        "--network=host",
        "--ipc=host",
        "--pid=host",
        "-v",
        f"{pkg_root}:{pkg_root}:ro",
        "-v",
        f"{tmp}:{tmp}",
        "-v",
        "/dev/shm:/dev/shm",
    ]
    if tmp != "/tmp":
        prefix += ["-v", "/tmp:/tmp"]
    for k, v in sorted(env.items()):
        if k == "PYTHONPATH" or k.startswith("RAY_TPU_"):
            prefix += ["--env", f"{k}={v}"]
    prefix += spec.get("run_options") or []
    prefix.append(spec["image"])
    inner = [spec.get("worker_python") or "python3"] + list(argv[1:])
    return prefix + inner, env


@contextlib.contextmanager
def applied(runtime_env: Optional[dict], ctx, permanent: bool = False):
    """Worker-side application. ``permanent=True`` (actors) leaves the env
    in place — the actor owns its process for life."""
    if not runtime_env:
        yield
        return
    saved_env: dict[str, Optional[str]] = {}
    saved_cwd = os.getcwd()
    saved_path = list(sys.path)

    def _restore():
        for k, old in saved_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        try:
            os.chdir(saved_cwd)
        except OSError:
            pass
        sys.path[:] = saved_path

    with contextlib.ExitStack() as stack:
        # registered FIRST so it unwinds LAST: plugin teardown must run in
        # the environment the plugin was set up in (env vars, working_dir,
        # sys.path still applied)
        stack.callback(_restore)
        for k, v in (runtime_env.get("env_vars") or {}).items():
            saved_env[k] = os.environ.get(k)
            os.environ[k] = v
        conda = runtime_env.get("conda")
        if conda:
            # conda ACTIVATION SEAM: like pip below, activation is in-process
            # — PATH/CONDA_PREFIX for the env's binaries + native libs, and
            # sys.path for its pure-python packages when the env's
            # interpreter minor version matches this worker's. A full
            # interpreter swap would slot in at worker spawn (next to the
            # container prefix in head._spawn_worker).
            prefix = ensure_conda_prefix(conda)
            for k, v in (
                ("PATH", os.path.join(prefix, "bin") + os.pathsep + os.environ.get("PATH", "")),
                ("CONDA_PREFIX", prefix),
                ("CONDA_DEFAULT_ENV", os.path.basename(prefix)),
            ):
                saved_env.setdefault(k, os.environ.get(k))
                os.environ[k] = v
            site = os.path.join(
                prefix, "lib", f"python{sys.version_info[0]}.{sys.version_info[1]}", "site-packages"
            )
            if os.path.isdir(site):
                sys.path.insert(0, site)
        reqs = runtime_env.get("pip")
        if reqs:
            # pip ACTIVATION SEAM (see module docstring): swap this
            # sys.path injection for an exec-based per-env interpreter to
            # get full process isolation
            sys.path.insert(0, ensure_pip_prefix(reqs, ctx))
        for ent in runtime_env.get("py_modules_keys") or []:
            root = _extract(ent["key"], ctx)
            if root not in sys.path:
                sys.path.insert(0, root)
        key = runtime_env.get("working_dir_key")
        if key:
            wd = _extract(key, ctx)
            os.chdir(wd)
            if wd not in sys.path:
                sys.path.insert(0, wd)  # reference: working_dir is importable
        for pkey, value in (runtime_env.get("plugins") or {}).items():
            plugin = _PLUGINS.get(pkey)
            if plugin is None:
                raise RuntimeError(
                    f"runtime_env plugin {pkey!r} is not registered in the "
                    f"worker process (register it in the task/actor module)"
                )
            stack.enter_context(plugin.apply(value, ctx))
        if permanent:
            stack.pop_all()  # actor lifetime: nothing is ever undone
        yield
