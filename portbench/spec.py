"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``file`` of its entry; a traffic mix is
``portbench/traffic/<traffic>.json``; a cell's limits (and the check's
parameters of that cell) are ``portbench/cells/<cell>.json``; a per-layer metric is the reader
``portbench/metrics/<metric>.py``; a configuration's plain reference is
``portbench/reference/<stem>.py``, ``<stem>`` its ``"reference"`` key or
``model``.  Adding any of them is adding a file and an entry: nothing here
names one.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the package a configuration's reference runs in: its ``__path__`` is the
#: run's own ``portbench/reference/``, so that a relative import (``from .
#: import model``) finds the sibling file of the root the run reads
REFERENCE_PACKAGE = "portbench_reference"


class Bench:
    """One ``BENCHMARK.json`` under ``root`` and its files."""

    def __init__(self, root=ROOT):
        self.root = pathlib.Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key, name):
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {key} entry named {name!r} in {self.root / 'BENCHMARK.json'}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._entry("configs", name)["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "portbench" / "traffic" / f"{name}.json").read_text())

    def check(self, cell: str) -> dict:
        """The cell's file: its ``limits`` and the check's parameters."""
        return json.loads((self.root / "portbench" / "cells" / f"{cell}.json").read_text())

    def limits(self, cell: str) -> dict:
        return self.check(cell)["limits"]

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics ``cell`` reports: those whose ``workloads``
        list it."""
        return [m for m in self.data["per_layer"] if cell in m["workloads"]]

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``portbench/metrics/<metric>.py``."""
        return _load(self.root / "portbench" / "metrics" / f"{metric}.py",
                     f"portbench_metric_{metric}").read

    def reference_path(self, config: dict) -> pathlib.Path:
        """The file of the plain reference of ``config``, a configuration
        file's contents."""
        return self.root / "portbench" / "reference" / f"{config.get('reference', 'model')}.py"

    def reference(self, config: dict):
        """The module at ``reference_path``: its ``logits_at`` and, where it
        adds layer kinds, its ``KINDS`` and ``INIT``.  It and the siblings it
        imports run anew from this root, in ``REFERENCE_PACKAGE``."""
        path = self.reference_path(config)
        for name in [n for n in sys.modules if n.split(".")[0] == REFERENCE_PACKAGE]:
            del sys.modules[name]
        package = types.ModuleType(REFERENCE_PACKAGE)
        package.__path__ = [str(path.parent)]
        sys.modules[REFERENCE_PACKAGE] = package
        return _load(path, f"{REFERENCE_PACKAGE}.{path.stem}")


def _load(path: pathlib.Path, name: str):
    """The module of the file at ``path``, run anew under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
