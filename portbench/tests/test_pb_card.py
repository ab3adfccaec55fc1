"""On the card: a whole run of a tiny cell through the card's kernels,
judged by the reference on the card."""

from __future__ import annotations

import json

import pytest

from . import pbutil


@pytest.mark.card
def test_tiny_cell_on_card(card, tmp_path, monkeypatch):
    from portbench import run

    monkeypatch.setattr(run, "TRACE_AFTER", 2)
    r = pbutil.bench_root(tmp_path)
    pbutil.add_cell(r, "p400-limbs.tiny", "tiny-p400-limbs", "closed",
                    config_body=pbutil.tiny_config("tiny-p400-limbs"))
    rc, lines, err = pbutil.run_cell(
        r, ["--workload", "p400-limbs.tiny", "--seed", "2147483659",
            "--seconds", "10", "--trace", "1"], device=str(card))
    assert rc == 0, err
    res = json.loads(lines[-1])
    assert res["correct"] is True, res["check"]
    assert res["device"]["busy_s"] > 0
