"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root, and under ``benchmark/`` the cell's workload file, its configuration
and traffic mix, and the modules they name (configuration, driver, entry,
per-layer metric), each loaded from its own file."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file, under a name of our own (metric files carry
    dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything a run of one cell reads, by the names in the files."""

    def __init__(self, name: str, root: Path = ROOT):
        self.name = name
        self.bench = read_json(root / "BENCHMARK.json")
        self.workload = read_json(BENCH_DIR / "workloads" / f"{name}.json")
        entry = next((w for w in self.bench["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"BENCHMARK.json has no workload {name!r}")
        for key in ("config", "traffic"):
            if entry[key] != self.workload[key]:
                raise ValueError(f"{name}: BENCHMARK.json says {key} "
                                 f"{entry[key]!r}, the workload file "
                                 f"{self.workload[key]!r}")
        self.chips = int(entry["chips"])
        self.config = read_json(BENCH_DIR / "configs"
                                / f"{entry['config']}.json")
        self.mix = read_json(BENCH_DIR / "traffic"
                             / f"{entry['traffic']}.json")
        self.limits: dict = self.workload["limits"]
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in self.bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def model(self):
        return load_module(BENCH_DIR / "models" / f"{self.config['name']}.py",
                           f"bench_model_{self.config['name']}")

    def driver(self):
        return load_module(BENCH_DIR / "drivers" / f"{self.mix['driver']}.py",
                           f"bench_driver_{self.mix['driver']}")

    def entry(self):
        return load_module(BENCH_DIR / "entries" / f"{self.mix['entry']}.py",
                           f"bench_entry_{self.mix['entry']}")

    def metric(self, name: str):
        """The reader of per-layer metric ``name``: ``metrics/<name>.py``,
        else the reader of its family, ``metrics/<name before the first
        dot>.py`` (``k1_roofline_pct.click`` and ``.bulk`` share
        ``k1_roofline_pct.py``, and with it their kernel names and bytes)."""
        path = BENCH_DIR / "metrics" / f"{name}.py"
        if not path.exists():
            path = BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"
        return load_module(path, "bench_metric_" + path.stem.replace(".", "_"))
