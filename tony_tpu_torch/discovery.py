"""GPU discovery: the scheduler-side resource census of the port.

The counterpart of :mod:`tony_tpu.discovery` (which counts TPU chips)
and of the reference's ``com.linkedin.tony.util.gpu.GpuDiscoverer``
(SURVEY.md §2.1: it shells out to ``nvidia-smi -q -x`` and parses the
XML so the AM can schedule and isolate GPUs). The count feeds the local
scheduler's ``total_gpus`` so an over-subscribed ``tony.<jobtype>.gpus``
ask fails at launch like an RM rejecting an unsatisfiable resource
request.

Sources, in order: ``nvidia-smi -q -x`` (parsed with ``xml.etree``),
the ``/dev/nvidia[0-9]*`` device nodes, and — opt-in, because importing
torch is heavy — ``torch.cuda.device_count()``. A census taken under a
``CUDA_VISIBLE_DEVICES`` restriction (indices or ``GPU-`` UUIDs) counts
only the cards it names, in its order, so the executor's pinning maps a
task's offset through the host's own visible list. Standard library
only.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List, Mapping, Optional, Tuple


@dataclass(frozen=True)
class GpuDevice:
    index: int             # nvidia-smi's index: the card's PCI-bus order
    uuid: str              # "GPU-..." ("" where the source has none)
    name: str              # product name ("" where the source has none)
    memory_mib: int        # framebuffer total, MiB (0 where unknown)


@dataclass(frozen=True)
class GpuTopology:
    num_gpus: int
    source: str            # nvidia-smi | devfs | torch | none
    devices: Tuple[GpuDevice, ...] = ()


_MIB_RE = re.compile(r"(\d+)\s*MiB")


def parse_nvidia_smi_xml(text: str) -> List[GpuDevice]:
    """The cards of one ``nvidia-smi -q -x`` document (the reference's
    ``GpuDiscoverer`` XML parse: ``<gpu>`` elements with ``uuid``,
    ``product_name`` and ``fb_memory_usage/total``). The document lists
    the cards in PCI-bus order, nvidia-smi's index, which is what a
    ``CUDA_VISIBLE_DEVICES`` index names under the
    ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` the port's runtimes export."""
    root = ET.fromstring(text)
    out = []
    for index, gpu in enumerate(root.iter("gpu")):
        mem = _MIB_RE.search(gpu.findtext("fb_memory_usage/total") or "")
        out.append(GpuDevice(
            index=index, uuid=(gpu.findtext("uuid") or "").strip(),
            name=(gpu.findtext("product_name") or "").strip(),
            memory_mib=int(mem.group(1)) if mem else 0))
    return out


def _devices_from_nvidia_smi() -> Optional[List[GpuDevice]]:
    try:
        proc = subprocess.run(["nvidia-smi", "-q", "-x"], capture_output=True,
                              text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0 or not proc.stdout.strip():
        return None
    try:
        return parse_nvidia_smi_xml(proc.stdout)
    except ET.ParseError:
        return None


def _devices_from_devfs(pattern: str = "/dev/nvidia[0-9]*"
                        ) -> Optional[List[GpuDevice]]:
    """One card a ``/dev/nvidiaN`` node; indices in node order (no UUID
    or name: without ``nvidia-smi`` only the count is sure)."""
    nodes = sorted(int(m.group(1)) for m in (
        re.search(r"nvidia(\d+)$", p) for p in glob.glob(pattern)) if m)
    if not nodes:
        return None
    return [GpuDevice(index=i, uuid="", name="", memory_mib=0)
            for i in range(len(nodes))]


def _devices_from_torch() -> Optional[List[GpuDevice]]:
    """The cards torch sees (already restricted to
    ``CUDA_VISIBLE_DEVICES``), or None where torch is missing or sees
    none: the last source, for a host whose CUDA install ships neither
    ``nvidia-smi`` nor readable device nodes."""
    try:
        import torch
    except ImportError:
        return None
    try:
        n = torch.cuda.device_count()
        props = [torch.cuda.get_device_properties(i) for i in range(n)]
    except (RuntimeError, AssertionError):   # a broken CUDA runtime
        return None
    if not props:
        return None
    out = []
    for i, prop in enumerate(props):
        uuid = str(getattr(prop, "uuid", "") or "")
        out.append(GpuDevice(index=i, uuid=f"GPU-{uuid}" if uuid else "",
                             name=prop.name,
                             memory_mib=prop.total_memory >> 20))
    return out


def restrict_to_visible(devices: List[GpuDevice],
                        visible: Optional[str]) -> List[GpuDevice]:
    """The cards a ``CUDA_VISIBLE_DEVICES`` value lets a process see, in
    its order: entries are indices or (prefixes of) ``GPU-`` UUIDs; as in
    CUDA, the list ends at the first entry that names no card. Unset
    means every card; an empty value means none."""
    if visible is None:
        return list(devices)
    out: List[GpuDevice] = []
    for entry in (e.strip() for e in visible.split(",")):
        if entry.isdigit():
            match = [d for d in devices if d.index == int(entry)]
        elif entry.startswith("GPU-"):
            match = [d for d in devices if d.uuid and d.uuid.startswith(entry)]
        else:
            match = []
        if len(match) != 1 or match[0] in out:
            break
        out.append(match[0])
    return out


def discover_gpus(use_torch: bool = False,
                  env: Mapping[str, str] = os.environ) -> GpuTopology:
    """Count this host's GPUs: ``nvidia-smi -q -x``, the device nodes,
    then (opt-in: importing torch costs seconds; the AM opts in, as the
    reference AM does with jax) torch itself, each restricted to
    ``CUDA_VISIBLE_DEVICES`` where that is set (torch applies the
    restriction itself)."""
    visible = env.get("CUDA_VISIBLE_DEVICES")
    for source, probe in (("nvidia-smi", _devices_from_nvidia_smi),
                          ("devfs", _devices_from_devfs)):
        devices = probe()
        if devices is not None:
            seen = restrict_to_visible(devices, visible)
            return GpuTopology(len(seen), source, tuple(seen))
    if use_torch:
        devices = _devices_from_torch()
        if devices is not None:
            return GpuTopology(len(devices), "torch", tuple(devices))
    return GpuTopology(0, "none")
