"""Everything the benchmark runs, found by name in its folder.

  configs/<name>.json    a configuration: its sizes as run, `source`,
                         `reduced`, `why`
  traffic/<name>.json    a traffic mix: the `mode` that drives it and its
                         parameters (lanes, steps, calls, check sample)
  workloads/<name>.json  a cell: `config`, `traffic`, `chips`, `why`, the
                         `metrics` it reports and the `limits` of its check
  metrics/<name>.py      a metric: `META` (unit, better, kind, source, and a
                         bound or a layer and what it moves; optionally the
                         `workloads` that report it) and `read(record)`
  modes/<name>.py        a way of driving the program: `Mode(config,
                         traffic, seed, device)` with setup, call and check
  settings.json          the command, the paths and `run_seconds`

A later change adds a configuration, a mix, a cell or a metric as new files;
`manifest()` builds BENCHMARK.json from them (`python3 -m benchmark.manifest`).
"""
from __future__ import annotations

import glob
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


class Registry:
    def __init__(self, root: str = HERE):
        self.root = root
        self._metrics = None

    def _json(self, kind: str, name: str) -> dict:
        path = os.path.join(self.root, kind, f"{name}.json")
        if not os.path.isfile(path):
            raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} "
                           f"({os.path.relpath(path, os.path.dirname(self.root))})")
        with open(path) as f:
            return json.load(f)

    def _names(self, kind: str, ext: str) -> list[str]:
        return sorted(os.path.basename(p)[:-len(ext)]
                      for p in glob.glob(os.path.join(self.root, kind, f"*{ext}")))

    def settings(self) -> dict:
        with open(os.path.join(self.root, "settings.json")) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def workload(self, name: str) -> dict:
        return self._json("workloads", name)

    def workloads(self) -> list[str]:
        return self._names("workloads", ".json")

    def mode_path(self, name: str) -> str:
        path = os.path.join(self.root, "modes", f"{name}.py")
        if not os.path.isfile(path):
            raise KeyError(f"no mode named {name!r}")
        return path

    def metrics(self) -> dict:
        """{name: module} of every metrics/<name>.py."""
        if self._metrics is None:
            self._metrics = {}
            for name in self._names("metrics", ".py"):
                path = os.path.join(self.root, "metrics", f"{name}.py")
                spec = importlib.util.spec_from_file_location(
                    "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                if mod.META["name"] != name:
                    raise ValueError(f"metrics/{name}.py declares {mod.META['name']!r}")
                self._metrics[name] = mod
        return self._metrics

    def cells_of(self, metric: str) -> list[str]:
        """The cells that report `metric`: those its META lists and those
        whose workload file lists it."""
        cells = set(self.metrics()[metric].META.get("workloads", ()))
        for w in self.workloads():
            if metric in self.workload(w).get("metrics", ()):
                cells.add(w)
        return sorted(cells)

    def cell_metrics(self, cell: str, kind: str) -> list[str]:
        """The metrics of `kind` ("end_to_end" or "per_layer") that `cell` reports."""
        return [m for m, mod in self.metrics().items()
                if mod.META["kind"] == kind and cell in self.cells_of(m)]

    def manifest(self) -> dict:
        """BENCHMARK.json as these files define it."""
        s = self.settings()
        cells = self.workloads()
        used = sorted({self.workload(w)["config"] for w in cells})
        configs = []
        for name in used:
            c = self.config(name)
            configs.append({"name": name, "source": c["source"],
                            "file": f"{s['paths'][0]}/configs/{name}.json",
                            "reduced": c["reduced"], "why": c["why"]})
        workloads = []
        for w in cells:
            d = self.workload(w)
            workloads.append({"name": w, "config": d["config"], "traffic": d["traffic"],
                              "chips": d["chips"], "why": d["why"]})
        e2e, layer = [], []
        for name, mod in self.metrics().items():
            m = mod.META
            where = self.cells_of(name)
            if not where:
                continue
            entry = {"name": name, "unit": m["unit"], "better": m["better"]}
            if m["kind"] == "end_to_end":
                entry.update(bound=m["bound"], source=m["source"])
                if where != cells:  # a metric of every cell names none
                    entry["workloads"] = where
                e2e.append(entry)
            else:
                entry.update(source=m["source"], layer=m["layer"], moves=m["moves"],
                             workloads=where)
                layer.append(entry)
        return {"command": s["command"], "paths": s["paths"], "run_seconds": s["run_seconds"],
                "configs": configs, "workloads": workloads, "end_to_end": e2e,
                "per_layer": layer}
