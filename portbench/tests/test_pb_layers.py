"""The attribution of the device's idle time to the program's layer
spans (``portbench/layers.py``) on synthetic traces."""

from __future__ import annotations

import types

import pytest

from portbench import layers
from portbench import trace as tr

# spans on the host's clock (ns): a phase around a linalg call around a
# kernel launcher, then a glue call; two spans of a second phase
RECORDS = [
    ("phases", "schur", 100, 1000, -1),
    ("linalg", "cholesky", 200, 600, 0),
    ("limb_kernels", "cholesky_unblocked_batched", 300, 400, 1),
    ("glue", "add", 700, 800, 0),
    ("phases", "xy_mu", 1100, 1500, -1),
    ("glue", "mul", 1100, 1500, 4),
]


def test_segments_give_the_innermost_span():
    assert layers.segments(RECORDS) == [
        (100, 200, 0), (200, 300, 1), (300, 400, 2), (400, 600, 1),
        (600, 700, 0), (700, 800, 3), (800, 1000, 0), (1100, 1500, 5)]


def test_a_gap_is_split_across_the_spans_it_covers():
    gaps = [(150, 350), (650, 750), (950, 1150), (1600, 1700)]
    got = layers.attribute(RECORDS, gaps)
    assert got["layer"] == {"phases": 50 + 50 + 50, "linalg": 100,
                            "limb_kernels": 50, "glue": 50 + 50,
                            "driver": 100 + 100}
    assert got["phase"] == {("schur", "phases"): 150,
                            ("schur", "linalg"): 100,
                            ("schur", "limb_kernels"): 50,
                            ("schur", "glue"): 50,
                            ("xy_mu", "glue"): 50, "driver": 200}
    assert got["span"][("limb_kernels", "cholesky_unblocked_batched")] == 50
    assert sum(got["layer"].values()) == sum(g1 - g0 for g0, g1 in gaps)


def _trace(ops, offset):
    """A DeviceTrace of ``ops`` (name, start_ns, stop_ns) on the device's
    clock."""
    dt = object.__new__(tr.DeviceTrace)
    dt.offset = offset
    dt.ops = sorted(ops, key=lambda o: o[1])
    dt.per_name = {}
    for name, t0, t1 in dt.ops:
        ns, n = dt.per_name.get(name, (0, 0))
        dt.per_name[name] = (ns + t1 - t0, n + 1)
    return dt


def _run(dt, iterations=2):
    busy = dt.busy_ns()
    first, last = dt.ops[0][1], max(t1 for _, _, t1 in dt.ops)
    return types.SimpleNamespace(trace=dt, traced_iterations=iterations,
                                 busy_s=busy / 1e9,
                                 traced_s=(last - first) / 1e9)


@pytest.fixture
def program(monkeypatch):
    """The program's records and counts as ``layers`` takes them."""
    taken = {"records": list(RECORDS),
             "counts": {("syncs", "driver._sync"): 4,
                        ("syncs", "conditions.cpu"): 6,
                        ("builds", "limb_kernels.build"): 1}}
    monkeypatch.setattr(layers, "_take",
                        lambda: (taken["records"], taken["counts"]))
    monkeypatch.setattr(layers, "_last", (None, None))
    return taken


def test_layer_idle_and_driver_idle_make_the_window_idle(program, capsys):
    off = 1_000_000
    # kernels launched at host times 120, 380, 780, 1200, 1550: the
    # device idles between them
    dt = _trace([("k", off + t, off + t + 20)
                 for t in (120, 380, 780, 1200, 1550)]
                + [("Memcpy DtoH (Device -> Pageable)", off + 1560,
                    off + 1570)], off)
    run = _run(dt)
    idle = {lay: layers.idle_ms(run, lay)
            for lay in ("phases", "linalg", "glue", "limb_kernels",
                        "driver")}
    # gaps on the host's clock: (140, 380), (400, 780), (800, 1200),
    # (1220, 1550)
    ns = {"phases": 60 + 100 + 200, "linalg": 100 + 200, "limb_kernels": 80,
          "glue": 80 + 100 + 280, "driver": 100 + 50}
    assert idle == pytest.approx({k: v / 1e6 / 2 for k, v in ns.items()})
    window_ms = (run.traced_s - run.busy_s) * 1e3 / 2
    assert sum(idle.values()) == pytest.approx(window_ms)
    assert layers.syncs(run) == 5.0
    err = capsys.readouterr().err
    assert "DtoH 0.5" in err and "builds limb_kernels.build 0.5" in err


def test_the_readers_share_one_taking(program):
    dt = _trace([("k", 10, 20), ("k", 200, 210)], 0)
    run = _run(dt, iterations=1)
    assert layers.syncs(run) == 10.0
    program["records"], program["counts"] = [], {}
    assert layers.syncs(run) == 10.0
    assert layers.idle_ms(run, "glue") is not None


@pytest.mark.parametrize("case", ["no program spans", "no records",
                                  "no device trace", "no marker"])
def test_nothing_to_read_gives_none(program, monkeypatch, case):
    dt = _trace([("k", 10, 20), ("k", 200, 210)], 0)
    run = _run(dt, iterations=1)
    if case == "no program spans":
        monkeypatch.setattr(layers, "_take", lambda: None)
    elif case == "no records":
        program["records"] = []
    elif case == "no device trace":
        run.trace = None
    else:
        dt.offset = None
    assert layers.idle_ms(run, "phases") is None
    if case == "no marker":
        assert layers.syncs(run) == 10.0
    else:
        assert layers.syncs(run) is None
