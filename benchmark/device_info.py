"""The device a run used, as the result's ``device`` entry, and the host's
counters that the run's log line gives beside its window."""

from __future__ import annotations

import os
import resource
import shutil
import subprocess

import torch


def power_limit_w():
    """The card's power limit in watts (``nvidia-smi``), or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(device, chips, memory_peak_bytes):
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(memory_peak_bytes),
            "power_limit_w": power_limit_w()}


def host_counters():
    """The process's CPU seconds and context switches, and the machine's
    CPU time stolen by its host (``/proc/stat``, all CPUs; None where
    unreadable)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        with open("/proc/stat") as f:
            steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        steal = None
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "ctx_vol": ru.ru_nvcsw,
            "ctx_invol": ru.ru_nivcsw, "steal_s": steal}


def counters_delta(a, b):
    return {k: (None if a[k] is None or b[k] is None else b[k] - a[k])
            for k in a}
