"""Persistence for checkpoints and experiment state (copy of
``ray_tpu/train/_storage.py``, with local paths freed of pyarrow).

Reference: ``python/ray/train/_internal/storage.py`` (StorageContext). The
reference resolves every path, local ones too, to a ``pyarrow.fs``
filesystem. Here a bare local path resolves to ``LOCAL``, which every
function below serves with ``os`` and ``shutil``, so training on a machine
without pyarrow keeps its checkpoints. A URI (``s3://…``, ``gs://…``,
``file:///…``) or a ``storage_filesystem`` goes through ``pyarrow.fs`` as in
the reference; pyarrow is imported only then, and its absence raises
``ImportError`` naming pyarrow (it is not replaced by anything else). The
on-disk layout is the reference's.
"""

from __future__ import annotations

import json
import os
import posixpath
import shutil
from typing import Optional, Tuple


class LocalFileSystem:
    """Marker for the local filesystem, served through ``os``/``shutil``."""

    def __repr__(self):
        return "LocalFileSystem()"


LOCAL = LocalFileSystem()


def is_uri(path: str) -> bool:
    return "://" in str(path)


def is_local(fs) -> bool:
    return fs is None or isinstance(fs, LocalFileSystem)


def pyarrow_fs():
    """``pyarrow.fs``, or an ``ImportError`` saying what needed it."""
    try:
        from pyarrow import fs as pafs
    except ImportError as e:
        raise ImportError(
            "a storage URI or a storage_filesystem needs pyarrow (pyarrow.fs), which "
            "is not installed; use a local path"
        ) from e
    return pafs


def get_fs_and_path(path: str, storage_filesystem=None) -> Tuple[object, str]:
    """Resolve ``path`` to ``(filesystem, fs-internal path)``: ``LOCAL`` and
    an absolute path for a local path, a ``pyarrow.fs.FileSystem`` for a URI.

    With ``storage_filesystem`` given, ``path`` is taken as already
    fs-internal (reference: ``StorageContext.__init__`` custom-fs branch).
    """
    if storage_filesystem is not None:
        return storage_filesystem, str(path).rstrip("/")
    if is_uri(path):
        return pyarrow_fs().FileSystem.from_uri(str(path))
    return LOCAL, os.path.abspath(os.path.expanduser(path))


def fs_join(*parts: str) -> str:
    return posixpath.join(*[p for p in parts if p != ""])


def exists(fs, fs_path: str) -> bool:
    if is_local(fs):
        return os.path.exists(fs_path)
    pafs = pyarrow_fs()
    return fs.get_file_info(fs_path).type != pafs.FileType.NotFound


def _copy_stream(src, dst) -> None:
    while True:
        chunk = src.read(4 << 20)
        if not chunk:
            break
        dst.write(chunk)


def upload_dir(fs, fs_path: str, local_dir: str) -> None:
    """Recursively copy a local directory into ``fs_path`` on ``fs``."""
    if is_local(fs):
        shutil.copytree(local_dir, fs_path, dirs_exist_ok=True)
        return
    fs.create_dir(fs_path, recursive=True)
    for root, _dirs, files in os.walk(local_dir):
        rel = os.path.relpath(root, local_dir)
        dest_root = fs_path if rel == "." else fs_join(fs_path, rel.replace(os.sep, "/"))
        if rel != ".":
            fs.create_dir(dest_root, recursive=True)
        for name in files:
            with open(os.path.join(root, name), "rb") as src, fs.open_output_stream(
                fs_join(dest_root, name)
            ) as dst:
                _copy_stream(src, dst)


def download_dir(fs, fs_path: str, local_dir: str) -> None:
    """Recursively copy ``fs_path`` on ``fs`` into a local directory."""
    if is_local(fs):
        shutil.copytree(fs_path, local_dir, dirs_exist_ok=True)
        return
    pafs = pyarrow_fs()
    os.makedirs(local_dir, exist_ok=True)
    selector = pafs.FileSelector(fs_path, recursive=True)
    for info in fs.get_file_info(selector):
        rel = posixpath.relpath(info.path, fs_path)
        dest = os.path.join(local_dir, *rel.split("/"))
        if info.type == pafs.FileType.Directory:
            os.makedirs(dest, exist_ok=True)
            continue
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with fs.open_input_stream(info.path) as src, open(dest, "wb") as dst:
            _copy_stream(src, dst)


def delete_dir(fs, fs_path: str) -> None:
    try:
        if is_local(fs):
            shutil.rmtree(fs_path)
        else:
            fs.delete_dir(fs_path)
    except FileNotFoundError:
        pass
    except OSError as e:
        # a silently-failed prune would let keep-N grow unboundedly with
        # zero operator signal — log, don't raise (the commit that
        # triggered the prune must still succeed)
        print(f"[ray_tpu_torch.train] storage delete of {fs_path!r} failed: {e!r}")


def write_json(fs, fs_path: str, obj) -> None:
    parent = posixpath.dirname(fs_path)
    data = json.dumps(obj, indent=1).encode()
    if is_local(fs):
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(fs_path, "wb") as f:
            f.write(data)
        return
    if parent:
        fs.create_dir(parent, recursive=True)
    with fs.open_output_stream(fs_path) as f:
        f.write(data)


def read_json(fs, fs_path: str):
    if is_local(fs):
        with open(fs_path, "rb") as f:
            return json.loads(f.read().decode())
    with fs.open_input_stream(fs_path) as f:
        return json.loads(f.read().decode())


class StorageContext:
    """One experiment's persistence root: ``<storage_path>/<experiment>/
    [<trial>]`` (reference: ``train/_internal/storage.py`` StorageContext
    fields of the same shape).

    ``uri_for(rel)`` returns a string that round-trips through
    :func:`get_fs_and_path` — the original URI form when one was given, else
    a plain local path.
    """

    def __init__(
        self,
        storage_path: str,
        experiment_name: str,
        trial_name: Optional[str] = None,
        storage_filesystem=None,
    ):
        self.storage_path = str(storage_path)
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.custom_fs = storage_filesystem is not None
        self.fs, self.base_path = get_fs_and_path(storage_path, storage_filesystem)
        self.experiment_fs_path = fs_join(self.base_path, experiment_name)
        self.trial_fs_path = (
            fs_join(self.experiment_fs_path, trial_name) if trial_name else None
        )

    def for_trial(self, trial_name: str) -> "StorageContext":
        ctx = StorageContext.__new__(StorageContext)
        ctx.storage_path = self.storage_path
        ctx.experiment_name = self.experiment_name
        ctx.trial_name = trial_name
        ctx.custom_fs = self.custom_fs
        ctx.fs = self.fs
        ctx.base_path = self.base_path
        ctx.experiment_fs_path = self.experiment_fs_path
        ctx.trial_fs_path = fs_join(self.experiment_fs_path, trial_name)
        return ctx

    # -- naming ------------------------------------------------------------
    def _rel_to_fs_path(self, rel: str) -> str:
        root = self.trial_fs_path or self.experiment_fs_path
        return fs_join(root, rel) if rel else root

    def uri_for(self, rel: str = "") -> str:
        """External name for ``rel`` under this context. URI-form storage
        paths keep their scheme so ``Checkpoint.from_uri`` round-trips."""
        if self.custom_fs:
            # no scheme to reconstruct — callers must hold the fs handle
            return self._rel_to_fs_path(rel)
        if is_uri(self.storage_path):
            scheme, rest = self.storage_path.split("://", 1)
            tail = [self.experiment_name]
            if self.trial_name:
                tail.append(self.trial_name)
            if rel:
                tail.append(rel)
            return f"{scheme}://{fs_join(rest.rstrip('/'), *tail)}"
        return self._rel_to_fs_path(rel)

    # -- operations --------------------------------------------------------
    def persist_dir(self, local_dir: str, rel: str) -> str:
        """Upload a local directory to ``rel`` under the trial root; returns
        its external name (see ``uri_for``)."""
        upload_dir(self.fs, self._rel_to_fs_path(rel), local_dir)
        return self.uri_for(rel)

    def restore_dir(self, rel: str, local_dir: str) -> str:
        download_dir(self.fs, self._rel_to_fs_path(rel), local_dir)
        return local_dir

    def delete(self, rel: str) -> None:
        delete_dir(self.fs, self._rel_to_fs_path(rel))

    def exists(self, rel: str = "") -> bool:
        return exists(self.fs, self._rel_to_fs_path(rel))

    def write_json(self, rel: str, obj) -> None:
        write_json(self.fs, self._rel_to_fs_path(rel), obj)

    def read_json(self, rel: str):
        return read_json(self.fs, self._rel_to_fs_path(rel))

    def list_dir(self, rel: str = "") -> list[str]:
        root = self._rel_to_fs_path(rel)
        if not exists(self.fs, root):
            return []
        if is_local(self.fs):
            return sorted(os.listdir(root))
        sel = pyarrow_fs().FileSelector(root, recursive=False)
        return sorted(posixpath.basename(i.path) for i in self.fs.get_file_info(sel))
