"""What the host did over a window, printed on standard error beside the
run's numbers, so that a run that reads far off can be told apart by its
cause: CPU time stolen by other guests, clocks, load, the process's own CPU
time and involuntary switches, and the card's clocks, power and throttle
reasons once the window has closed."""

from __future__ import annotations

import os
import resource
import subprocess
import time

_CPU_FIELDS = ("user", "nice", "system", "idle", "iowait", "irq",
               "softirq", "steal")


def _cpu_jiffies() -> dict:
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()[1: 1 + len(_CPU_FIELDS)]
        return dict(zip(_CPU_FIELDS, map(int, parts)))
    except OSError:
        return {}


def _cpu_mhz() -> list:
    try:
        with open("/proc/cpuinfo") as f:
            return [float(line.split(":")[1]) for line in f
                    if line.startswith("cpu MHz")]
    except OSError:
        return []


def _governor() -> str:
    try:
        with open("/sys/devices/system/cpu/cpu0/cpufreq/"
                  "scaling_governor") as f:
            return f.read().strip()
    except OSError:
        return "none exposed"


def snapshot() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "cpu": _cpu_jiffies(),
            "mhz": _cpu_mhz(), "cpu_s": ru.ru_utime + ru.ru_stime,
            "nivcsw": ru.ru_nivcsw}


def _mhz(v: list) -> str:
    return (f"{sum(v) / len(v):.0f} ({min(v):.0f}-{max(v):.0f})" if v
            else "not exposed")


def gpu_state() -> str:
    """The card's clocks, power and throttle reasons (``nvidia-smi``)."""
    q = ("clocks.sm,clocks.max.sm,clocks.mem,power.draw,power.limit,"
         "temperature.gpu,clocks_throttle_reasons.active")
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return f"{q}: {out.stdout.strip() or out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e!r})"


def report(a: dict, b: dict) -> str:
    """One line: the host over the stretch between two snapshots."""
    wall = b["t"] - a["t"]
    d = {k: b["cpu"].get(k, 0) - a["cpu"].get(k, 0) for k in _CPU_FIELDS}
    total = max(sum(d.values()), 1)
    share = {k: 100.0 * d[k] / total for k in ("idle", "iowait", "steal")}
    return (f"host over {wall:.3f} s: {os.cpu_count()} CPUs, "
            f"affinity {len(os.sched_getaffinity(0))}, steal "
            f"{share['steal']:.2f} %, idle {share['idle']:.2f} %, iowait "
            f"{share['iowait']:.2f} %, load {os.getloadavg()[0]:.2f}; this "
            f"process {b['cpu_s'] - a['cpu_s']:.3f} CPU s, "
            f"{b['nivcsw'] - a['nivcsw']} involuntary switches; cpu MHz "
            f"{_mhz(a['mhz'])} then {_mhz(b['mhz'])}; governor "
            f"{_governor()}")
