"""The port's front end (pmp_writer, pmp/*, sdp_bin's writer, pmp2sdp
and its deprecated forwarders) against sdpb_tpu's, on the CPU.

Both are host code over mpmath; the same input must give SDP
directories equal byte for byte, in the binary and the JSON block
formats.  Inputs: the quickstart PMP (examples/quickstart.py), a 2x2
PMP with poles (one of them repeated) made from a numpy seed, and small
XML and Mathematica files written here.  The quickstart compiled at
-p 768 must equal the SDP committed for the port's own tests.
"""

import pathlib

import numpy as np
import pytest

from sdpb_tpu.apps import pmp2sdp as jax_pmp2sdp
from sdpb_tpu.apps import pvm2sdp as jax_pvm2sdp
from sdpb_tpu.apps import sdp2input as jax_sdp2input
from sdpb_tpu_torch.apps import pmp2sdp, pvm2sdp, sdp2input
from sdpb_tpu_torch.io import pmp_writer

ROOT = pathlib.Path(__file__).resolve().parents[1]
SDP_1D = ROOT / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp"


def _tree(path: pathlib.Path) -> dict:
    return {p.relative_to(path).as_posix(): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


def _quickstart(path):
    pmp_writer.write_pmp_json(
        path, objective=[0, -1], normalization=[1, 0],
        matrices=[pmp_writer.PositiveMatrixWithPrefactor(
            prefactor=pmp_writer.DampedRational(
                constant=1, base="0.36787944117144233", poles=[]),
            polynomials=[[[[1, 0, 0, 0, 1], [0, 0, 1, 0, "1/12"]]]])])


def _two_by_two_with_poles(path):
    """A 2x2 positive matrix of degree-3 polynomial vectors (three
    decision variables) with the prefactor poles -0.5, -1.25, -1.25."""
    rng = np.random.default_rng(7)

    def poly():
        return [f"{c:.6f}" for c in rng.uniform(-1.0, 1.0, 4)]

    diag = lambda: [[3, 0, 1, 0], poly(), poly()]
    off = [poly(), poly(), poly()]
    pmp_writer.write_pmp_json(
        path, objective=[0, 1, -1], normalization=[1, 0, 0],
        matrices=[pmp_writer.PositiveMatrixWithPrefactor(
            prefactor=pmp_writer.DampedRational(
                constant="0.75", base="0.5", poles=["-0.5", "-1.25",
                                                    "-1.25"]),
            polynomials=[[diag(), off], [off, diag()]])])


MATHEMATICA = """SDP[{0, -1}, {1, 0}, {PositiveMatrixWithPrefactor[
  DampedRational[1, {}, 0.36787944117144233, x],
  {{{1 + x^4, x^2 + 0.0833333333333333333333*x^4 - 2.5`30*^-3*x^3}}}]}]
"""


def _compile_both(tmp_path, monkeypatch, name, argv):
    """Run sdpb_tpu's pmp2sdp and the port's with the same arguments
    (the command line is stored in control.json), each in a directory
    of its own holding the input; return both output trees."""
    trees = []
    for tag, main in (("jax", jax_pmp2sdp.main), ("torch", pmp2sdp.main)):
        work = tmp_path / tag
        work.mkdir()
        (work / name).write_bytes((tmp_path / name).read_bytes())
        monkeypatch.chdir(work)
        assert main(["-i", name, "-o", "sdp"] + argv) == 0
        trees.append(_tree(work / "sdp"))
    return trees


@pytest.mark.parametrize("fmt", ["bin", "json"])
@pytest.mark.parametrize("case", ["quickstart", "poles"])
def test_pmp2sdp_matches_sdpb_tpu_byte_for_byte(tmp_path, monkeypatch, case,
                                                fmt):
    write = _quickstart if case == "quickstart" else _two_by_two_with_poles
    write(tmp_path / "pmp.json")
    theirs, ours = _compile_both(tmp_path, monkeypatch, "pmp.json",
                                 ["-p", "256", "-f", fmt, "-v", "0"])
    assert ours.keys() == theirs.keys()
    assert f"block_data_0.{fmt}" in ours
    for name in ours:
        assert ours[name] == theirs[name], name


def test_quickstart_reproduces_the_committed_sdp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _quickstart(tmp_path / "pmp.json")
    assert pmp2sdp.main(["-p", "768", "-i", "pmp.json", "-o",
                         "quickstart_1d_sdp", "-v", "0"]) == 0
    got = _tree(tmp_path / "quickstart_1d_sdp")
    # the committed data was made without -v 0 in the command line
    want = _tree(SDP_1D)
    assert got.keys() == want.keys()
    for name in got:
        if name != "control.json":
            assert got[name] == want[name], name


@pytest.mark.parametrize("fmt", ["xml", "m"])
def test_xml_and_mathematica_inputs_match_sdpb_tpu(tmp_path, monkeypatch,
                                                   fmt):
    if fmt == "xml":
        pmp_writer.write_pmp_xml(
            tmp_path / "pmp.xml", objective=[0, -1],
            matrices=[pmp_writer.PositiveMatrixWithPrefactor(
                polynomials=[[[[1, 0, 0, 0, 1], [0, 0, 1, 0, "1/12"]]]])])
    else:
        (tmp_path / "pmp.m").write_text(MATHEMATICA)
    theirs, ours = _compile_both(tmp_path, monkeypatch, f"pmp.{fmt}",
                                 ["-p", "192", "-v", "0"])
    assert ours == theirs


def test_deprecated_forwarders_match_sdpb_tpu(tmp_path, monkeypatch):
    _quickstart(tmp_path / "pmp.json")
    pmp_writer.write_pmp_xml(
        tmp_path / "pmp.xml", objective=[0, -1],
        matrices=[pmp_writer.PositiveMatrixWithPrefactor(
            polynomials=[[[[1, 0, 1], [0, 1, 0]]]])])
    trees = []
    for tag, s2i, p2s in (("jax", jax_sdp2input.main, jax_pvm2sdp.main),
                          ("torch", sdp2input.main, pvm2sdp.main)):
        work = tmp_path / tag
        work.mkdir()
        for name in ("pmp.json", "pmp.xml"):
            (work / name).write_bytes((tmp_path / name).read_bytes())
        monkeypatch.chdir(work)
        assert s2i(["-i", "pmp.json", "-o", "s2i", "-p", "128"]) == 0
        assert p2s(["128", "pmp.xml", "p2s"]) == 0
        trees.append((_tree(work / "s2i"), _tree(work / "p2s")))
    assert trees[0] == trees[1]
