"""A copy of the benchmark's files in a temporary root, with tiny cells
added as new files, for the tests on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CONFIG = "nmax6-p400-limbs"
# a tiny SDP of two shape buckets, for a configuration of its own
TINY = {"blocks": [[2, 2, 8], [1, 3, 6]], "n_dual": 16}


def bench_root(tmp: Path) -> Path:
    """BENCHMARK.json and portbench/ copied under ``tmp``."""
    root = tmp / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def tiny_config(name: str, **over) -> dict:
    """The benchmark's configuration on the tiny SDP, named ``name``."""
    config = json.loads(
        (REPO / f"portbench/configs/{CONFIG}.json").read_text())
    config.update(TINY, name=name, **over)
    return config


def add_cell(root: Path, name: str, config: str, traffic: str,
             traffic_body: dict | None = None, limits: dict | None = None,
             config_body: dict | None = None, metrics=()) -> None:
    """A new cell by new files and new entries only: its traffic mix
    (default: a copy of ``closed``), its limits (default: those of the
    first cell), optionally a new configuration, and per-layer metrics
    extended to it."""
    here = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if config_body is not None:
        path = f"portbench/configs/{config}.json"
        (root / path).write_text(json.dumps(config_body))
        bench["configs"].append({"name": config, "source": "test",
                                 "file": path, "reduced": [],
                                 "why": "test"})
    if traffic_body is None and not (
            here / "traffic" / f"{traffic}.json").exists():
        traffic_body = json.loads(
            (here / "traffic" / "closed.json").read_text())
    if traffic_body is not None:
        (here / "traffic" / f"{traffic}.json").write_text(
            json.dumps(traffic_body))
    if limits is None:
        first = bench["workloads"][0]["name"]
        limits = json.loads((here / "limits" / f"{first}.json").read_text())
    (here / "limits" / f"{name}.json").write_text(json.dumps(limits))
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(name)
    for m in metrics:
        bench["per_layer"].append(m)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def run_cell(root: Path, argv: list, device: str = "cpu") -> tuple:
    """(exit code, stdout lines, stderr) of one run, on the CPU unless
    ``device`` says otherwise."""
    from portbench import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.run(argv, device=device, root=root)
    return rc, out.getvalue().splitlines(), err.getvalue()
