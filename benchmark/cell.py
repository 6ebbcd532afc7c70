"""What one cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``benchmark/workloads/<cell>.json`` (its configuration,
driver, chips, traffic and limits), ``benchmark/configs/<config>.json``,
the module ``benchmark.drivers.<driver>`` and ``benchmark/metrics/<metric>.py``
(loaded by path: a metric's name holds dots).  A cell, configuration or
metric is added by adding files and entries."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tumblr_emotions_tpu")


@dataclasses.dataclass
class Ctx:
    """What a driver is given: the cell's files, the run's arguments, the
    device and the process's start on ``time.perf_counter``'s clock."""

    name: str
    workload: Dict
    config: Dict
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float

    @property
    def traffic(self) -> Dict:
        return self.workload["traffic"]


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, tuple]            # name -> (value, limit, where)
    memory_peak_bytes: int
    reading: Optional[object] = None    # a Reading, in a traced run
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)  # set-up, s


@dataclasses.dataclass
class Reading:
    """What the per-layer metrics read from a traced window: its trace,
    the units of work done in it (batches or steps) and the rows of each,
    the program's counters and the benchmark's spans."""

    trace: object
    units: int
    rows: int
    counters: Dict[str, float]
    config: Dict
    workload: Dict


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    name = "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name: str) -> Dict:
    wl = load_json(HERE / "workloads" / f"{name}.json")
    wl["config_file"] = load_json(HERE / "configs" / f"{wl['config']}.json")
    return wl


def metrics_of(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` the per-layer metrics that name it (or, naming no cell,
    move one of its end-to-end metrics)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moves)]


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def port_config(config: Dict):
    """The program's ``Config``: the preset the configuration file names,
    with every value the file states put in."""
    from tumblr_emotions_torch import get_preset

    cfg = get_preset(config["preset"])
    parts = {}
    for part in ("image", "text", "data", "train"):
        if part in config:
            parts[part] = getattr(cfg, part).replace(**config[part])
    return cfg.replace(**parts)


def model_sizes(config: Dict) -> Dict:
    """The joint model's sizes, as ``reference.model.param_shapes`` takes them."""
    im, tx = config["image"], config["text"]
    return dict(image_size=im["image_size"], depth_multiplier=im["depth_multiplier"],
                num_classes=im["num_classes"], vocab_size=tx["vocab_size"],
                embed_dim=tx["embed_dim"])


def hyper(config: Dict) -> Dict:
    """The configuration's numbers as one flat dict (the reference's view)."""
    out = {}
    for part in ("image", "text", "data", "train"):
        out.update(config.get(part, {}))
    return out
