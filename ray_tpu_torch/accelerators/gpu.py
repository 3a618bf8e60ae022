"""GPU detection and resource synthesis: the port's counterpart of
``ray_tpu/accelerators/tpu.py``.

``init()`` with no arguments asks this module how many cards the host has
and offers them as the ``GPU`` resource, beside an accelerator-type
resource named after the card (``GPU-NVIDIA-H100-80GB-HBM3``), as the
reference offers ``TPU-{acc}``.

Detection never imports torch (worker spawn must stay light, and a
forkserver template that initialised CUDA would hand every forked worker a
card it cannot use). It probes, in order: ``CUDA_VISIBLE_DEVICES``, then
``nvidia-smi -L``, and finally ``torch.cuda.device_count()`` if (and only
if) torch is already imported in this process.

The runtime counts ``GPU`` but gives no task or actor a card index of its
own, so a process holding a share is bound here: ``bind_cards`` narrows its
``CUDA_VISIBLE_DEVICES`` to the cards of that share at its index in its
group, before it touches CUDA. Train workers bind by local rank; an actor
placed with ``card_share_options`` is bound by the worker before its
``__init__``. A group packs from the node's first card and does not see
the cards other groups hold (ROADMAP.md, queue A8).
"""

from __future__ import annotations

import math
import os
import re
import subprocess
import sys
from typing import Optional


def visible_devices() -> Optional[list[str]]:
    """The ids ``CUDA_VISIBLE_DEVICES`` lists, or None when it is unset. As
    CUDA reads it, the list ends at the first invalid (negative) entry, so
    ``""`` and ``"-1"`` hide every card."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is None:
        return None
    ids = []
    for tok in env.split(","):
        tok = tok.strip()
        if not tok or tok.startswith("-"):
            break
        ids.append(tok)
    return ids


def nvidia_smi_cards() -> Optional[list[str]]:
    """Card names in the order ``nvidia-smi -L`` lists them, or None when
    the tool is missing or fails."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True, text=True, timeout=20
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    names = []
    for line in proc.stdout.splitlines():
        m = re.match(r"GPU (\d+): (.+?)(?: \(UUID: [^)]*\))?$", line.strip())
        if m:
            names.append(m.group(2).strip())
    return names


def detect_num_gpus() -> int:
    """Number of GPUs this host offers to the cluster."""
    visible = visible_devices()
    if visible is not None:
        return len(visible)
    cards = nvidia_smi_cards()
    if cards is not None:
        return len(cards)
    # only consult torch if something else in the process already paid its
    # import cost (drivers typically have; fresh workers have not)
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            return int(torch.cuda.device_count())
        except Exception:
            return 0
    return 0


def accelerator_type() -> Optional[str]:
    """The first visible card's name with spaces as dashes
    (``NVIDIA-H100-80GB-HBM3``), or None when it cannot be read without
    initialising CUDA."""
    name = None
    cards = nvidia_smi_cards()
    if cards:
        visible = visible_devices()
        index = 0
        if visible and visible[0].isdigit():
            index = int(visible[0])
        if visible == []:
            return None
        name = cards[index] if index < len(cards) else cards[0]
    else:
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            name = torch.cuda.get_device_name(0)
    if not name:
        return None
    return re.sub(r"\s+", "-", name.strip())


def extra_resources(num_gpus: int) -> dict[str, float]:
    """The accelerator-type resource, ``GPU-{type}: num_gpus``, for affinity
    (``resources={"GPU-NVIDIA-H100-80GB-HBM3": 0.01}`` pins a task to such
    a host)."""
    if num_gpus <= 0:
        return {}
    acc = accelerator_type()
    return {f"GPU-{acc}": float(num_gpus)} if acc else {}


#: runtime_env variable that carries an actor's ``"index:gpus"`` share; the
#: worker binds it (``bind_from_env``) before the actor's ``__init__``
CARD_SHARE_ENV = "RAY_TPU_TORCH_CARD_SHARE"


def bind_cards(index: int, gpus: float, what: str = "worker") -> Optional[str]:
    """Narrow ``CUDA_VISIBLE_DEVICES`` to this process's share of the node's
    cards: ``ceil(gpus)`` of them from card ``floor(index * gpus)`` (a
    fractional share packs a group's processes onto one card). Returns the
    ids bound, or None when the node lists no cards. Raises if the share
    lies past the node's cards, or if CUDA is already up in this process
    and the share is not every card it sees (CUDA would not see the
    change)."""
    ids = visible_devices()
    if ids is None:
        cards = nvidia_smi_cards()
        ids = None if cards is None else [str(i) for i in range(len(cards))]
    if ids is None:
        return None
    start = math.floor(index * gpus)
    share = ids[start : start + max(1, math.ceil(gpus))]
    if start + len(share) > len(ids) or not share:
        raise RuntimeError(
            f"{what} at index {index} needs {gpus} GPU from card index {start}, "
            f"but this node shows {len(ids)} card(s): {ids}"
        )
    torch = sys.modules.get("torch")
    if share != ids and torch is not None and torch.cuda.is_initialized():
        raise RuntimeError(f"{what} initialised CUDA before its card was bound")
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(share)
    return os.environ["CUDA_VISIBLE_DEVICES"]


def card_share_options(index: int, gpus: float) -> dict:
    """Actor options that hold ``gpus`` of a GPU and have the worker bind
    the actor's process to that share at ``index`` of its group
    (``bind_cards``) before the actor's ``__init__``. Empty for no share."""
    if gpus <= 0:
        return {}
    return dict(num_gpus=gpus, runtime_env={"env_vars": {CARD_SHARE_ENV: f"{index}:{gpus!r}"}})


def bind_from_env() -> Optional[str]:
    """Bind this process to the share ``CARD_SHARE_ENV`` names, if any."""
    spec = os.environ.get(CARD_SHARE_ENV)
    if not spec:
        return None
    index, gpus = spec.split(":")
    return bind_cards(int(index), float(gpus), "actor")
