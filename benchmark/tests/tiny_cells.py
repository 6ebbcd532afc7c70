"""The benchmark's cells shrunk to run on the CPU in seconds (depth 0.25,
139 px, a small vocabulary and batch), and a run of ``run.py`` over them."""

from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import cell  # noqa: E402


def shrink(wl: dict) -> dict:
    cfg = wl["config_file"]
    cfg["image"].update(image_size=139, depth_multiplier=0.25)
    cfg["text"].update(vocab_size=1000)
    t = wl["traffic"]
    t["captions"].update(vocab_size=1000)
    t.update(batch=min(t["batch"], 16), pool_batches=3, image_hw=[160, 170],
             trace_seconds=1)
    if "calibration_images" in t:
        t.update(calibration_images=16, check_posts=16)
    if "train" in cfg:
        cfg["train"].update(batch_size=t["batch"])
    return wl


def run(workload: str, seed: int = 2**31 + 5, seconds: float = 0.5, trace: int = 0,
        limits=None):
    """``run.py``'s main on the CPU over the shrunk cell: (exit code,
    result dict or None, standard error)."""
    from benchmark import run as run_mod

    real = cell.workload

    def tiny(name):
        wl = shrink(real(name))
        if limits:
            wl["limits"].update(limits)
        return wl

    out, err = io.StringIO(), io.StringIO()
    with mock.patch.object(cell, "workload", tiny), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        code = run_mod.main(["--workload", workload, "--seed", str(seed), "--seconds",
                             str(seconds), "--trace", str(trace)], device=torch.device("cpu"))
    lines = out.getvalue().strip().splitlines()
    return code, (json.loads(lines[-1]) if lines else None), err.getvalue()
