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
"""

from __future__ import annotations

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
