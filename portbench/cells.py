"""Find a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names every cell
(``workloads``), its configuration (``configs``, each with the file of
its sizes) and its traffic mix; the harness finds everything else by
name under ``portbench/``:

* ``portbench/traffic/<mix>.json``   the mix's parameters;
* ``portbench/signals/<signal>.py``  the builder of the cell's input, named
  by the mix's ``signal`` key;
* ``portbench/entries/<entry>.py``   how a mix drives the program, named by
  the mix's ``entry`` key;
* ``portbench/metrics/<metric>.py``  the reader of one per-layer metric
  (named by the metric's name up to its first dot);
* ``portbench/limits/<cell>.json``   the limits of the comparison that
  decides ``correct``, and the size of its sample.

So a configuration, a mix, a cell or a metric is added with new files and
new entries only.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

PKG = "portbench"


class Cell(NamedTuple):
    root: Path          # the checkout: BENCHMARK.json and portbench/ under it
    bench: dict         # BENCHMARK.json
    workload: dict      # the cell's entry of ``workloads``
    config: dict        # the configuration's file
    traffic: dict       # the mix's file
    limits: dict        # the cell's limits file

    @property
    def name(self) -> str:
        return self.workload["name"]

    def end_to_end(self) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"] if _reports(m, self.name)]

    def per_layer(self) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root, workload: str) -> Cell:
    """The named cell of ``<root>/BENCHMARK.json`` with its files."""
    root = Path(root)
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are: {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    traffic = _read_json(root / PKG / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(root / PKG / "limits" / f"{workload}.json")
    return Cell(root, bench, w, config, traffic, limits)


def _load_module(root: Path, kind: str, name: str):
    """``<root>/portbench/<kind>/<name>.py`` as a module."""
    path = Path(root) / PKG / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(f"{PKG}.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(cell: Cell):
    """The module that drives the program for this cell's mix."""
    return _load_module(cell.root, "entries", cell.traffic["entry"])


def signal_builder(cell: Cell):
    """The ``build(mix, config, seed, device)`` function of this cell's signal."""
    return _load_module(cell.root, "signals", cell.traffic["signal"]).build


def metric_reader(cell: Cell, metric: str):
    """The ``read(ctx)`` function of a per-layer metric: the module named by
    the metric's name up to its first dot (``k1_roofline.stream`` and
    ``k1_roofline.session`` read the same quantity in different cells)."""
    return _load_module(cell.root, "metrics", metric.split(".")[0]).read
