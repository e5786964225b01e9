"""What each run records beside its numbers: the card's name and power
limit, its SM clock, power and temperature sampled during the window, and
the host's CPU model, core count and load average.  Written to standard
error and to a file under the run's temporary directory, never into the
result's line."""

from __future__ import annotations

import json
import os
import platform
import statistics
import subprocess
import tempfile
from pathlib import Path

SMI_QUERY = "clocks.sm,power.draw,temperature.gpu"


def _smi(args: list) -> str | None:
    try:
        return subprocess.run(["nvidia-smi", *args], capture_output=True, text=True,
                              check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def cpu_model() -> str:
    """The CPU's model name, from /proc/cpuinfo or ``lscpu``."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return platform.machine() or "unknown"
    fields = dict(ln.split(":", 1) for ln in out.splitlines() if ":" in ln)
    return " ".join(fields.get(k, "").strip() for k in ("Vendor ID", "Model name")).strip() \
        or platform.machine() or "unknown"


def host_record(device_index: int) -> dict:
    return {"card_name_power_limit": _smi(["-i", str(device_index),
                                           "--query-gpu=name,power.limit",
                                           "--format=csv,noheader"]),
            "cpu_model": cpu_model(), "cpu_cores": os.cpu_count(),
            "load_average": list(os.getloadavg())}


class ClockSampler:
    """``nvidia-smi`` sampling the card once a second while it runs."""

    def __init__(self, device_index: int, period_ms: int = 1000):
        self.args = ["nvidia-smi", "-i", str(device_index), f"--query-gpu={SMI_QUERY}",
                     "--format=csv,noheader,nounits", f"-lms={period_ms}"]
        self.proc = None
        self.lines: list[str] = []

    def start(self) -> None:
        try:
            self.proc = subprocess.Popen(self.args, stdout=subprocess.PIPE,
                                         stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> None:
        if self.proc is None:
            return
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.lines = [ln for ln in out.splitlines() if ln.strip()]
        self.proc = None

    def summary(self) -> dict:
        cols = {"sm_clock_mhz": [], "power_w": [], "temperature_c": []}
        for ln in self.lines:
            parts = [p.strip() for p in ln.split(",")]
            if len(parts) != 3:
                continue
            for key, v in zip(cols, parts):
                try:
                    cols[key].append(float(v))
                except ValueError:
                    pass
        return {k: {"n": len(v), "min": min(v), "median": statistics.median(v),
                    "max": max(v)} for k, v in cols.items() if v}


def write_record(name: str, record: dict) -> Path:
    """The record as JSON under ``$TMPDIR/portbench/``."""
    path = Path(tempfile.gettempdir()) / "portbench" / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1))
    return path
