"""Cells, configurations and traffic mixes, found by name.

A cell is ``workloads/<cell>.json`` (its configuration's and traffic
mix's names, and the limits of its comparison with the reference); a
configuration is ``configs/<name>.json`` (the sizes as run, the source,
what was reduced and assumed); a traffic mix is ``traffic/<name>.json``
(the parameters the one generator reads).  Adding any of them is adding
a file: nothing here names one.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("workloads", "configs", "traffic")


class UnknownName(LookupError):
    """No file of that kind and name under the benchmark's folder."""


def load(kind: str, name: str) -> Dict[str, Any]:
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} is not one of {KINDS}")
    path = ROOT / kind / f"{name}.json"
    if "/" in name or not path.is_file():
        known = sorted(p.stem for p in (ROOT / kind).glob("*.json"))
        raise UnknownName(f"no {kind[:-1] if kind != 'traffic' else kind} "
                          f"named {name!r}; known: {known}")
    return json.loads(path.read_text())


def names(kind: str):
    return sorted(p.stem for p in (ROOT / kind).glob("*.json"))


def cell(name: str) -> Dict[str, Any]:
    """The cell's own file with its configuration and traffic mix read
    in: ``{"name", "config": {...}, "traffic": {...}, "limits": {...}}``."""
    w = load("workloads", name)
    return {"name": name, "config": load("configs", w["config"]),
            "traffic": load("traffic", w["traffic"]),
            "limits": w["limits"]}
