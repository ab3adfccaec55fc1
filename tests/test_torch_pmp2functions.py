"""The port's pmp2functions against sdpb_tpu's, on the CPU.

Both are host mpmath over their own PMP readers: the same PMP must give
functions files equal byte for byte.  Inputs: the quickstart PMP
(examples/quickstart.py) and the 2x2 PMP with poles of
test_torch_frontend.py, whose diagonal degrees (3 + 3) exceed twice the
off-diagonal's (2 * 3 = 6 is not below 6, so here the two are equal and
nothing is zeroed) -- and a variant whose off-diagonal entries are of
degree 4, where the limiting-determinant fix zeroes the diagonal's
max degrees.  A 3x3 block is refused by both.
"""

import json

import pytest

from sdpb_tpu.apps import pmp2functions as jax_pmp2functions
from sdpb_tpu_torch.apps import pmp2functions
from sdpb_tpu_torch.io import pmp_writer

from test_torch_frontend import _quickstart, _two_by_two_with_poles


def _off_diagonal_dominant(path):
    """A 2x2 PMP whose off-diagonal polynomials have degree 4 and the
    diagonal's degree 2: 2 * 4 > 2 + 2, so pmp2functions zeroes the
    diagonal entries' max degrees (`write_functions.cxx:110-131`)."""
    diag = [["2", "0", "1"], ["0.5", "0.25", "0.125"]]
    off = [["0", "0", "0", "0", "0.01"], ["0.1", "0", "0", "0", "0.02"]]
    pmp_writer.write_pmp_json(
        path, objective=[0, -1], normalization=[1, 0],
        matrices=[pmp_writer.PositiveMatrixWithPrefactor(
            prefactor=pmp_writer.DampedRational(
                constant=1, base="0.36787944117144233", poles=["-0.5"]),
            polynomials=[[diag, off], [off, diag]])])


CASES = {"quickstart": _quickstart, "poles": _two_by_two_with_poles,
         "off_diagonal": _off_diagonal_dominant}


def _both(tmp_path, case, precision):
    CASES[case](tmp_path / "pmp.json")
    out = []
    for tag, main in (("jax", jax_pmp2functions.main),
                      ("torch", pmp2functions.main)):
        path = tmp_path / tag / "functions.json"
        assert main(["-p", str(precision), "-i", str(tmp_path / "pmp.json"),
                     "-o", str(path), "-v", "0"]) == 0
        out.append(path.read_bytes())
    return out


@pytest.mark.parametrize("precision", [128, 512])
@pytest.mark.parametrize("case", sorted(CASES))
def test_functions_file_byte_for_byte(tmp_path, case, precision):
    jax_bytes, torch_bytes = _both(tmp_path, case, precision)
    assert torch_bytes == jax_bytes
    doc = json.loads(torch_bytes)
    assert len(doc["objective"]) == len(doc["normalization"])


def test_limiting_determinant_fix(tmp_path):
    """In the off-diagonal-dominant block the diagonal entries' max
    degree is zeroed, so their infinity_value is the constant term; the
    off-diagonal entries keep their leading coefficient."""
    _, torch_bytes = _both(tmp_path, "off_diagonal", 128)
    block = json.loads(torch_bytes)["functions"][0]
    assert [f["infinity_value"] for f in block[0][0]] == ["2.0", "5.0e-1"]
    assert [f["infinity_value"][:6] for f in block[0][1]] == [
        "1.0000", "2.0000"]


def _three_by_three(path):
    one = [["1", "0", "1"], ["0", "1"]]
    zero = [["0"], ["0"]]
    rows = [[one if r == c else zero for c in range(3)] for r in range(3)]
    pmp_writer.write_pmp_json(
        path, objective=[0, -1], normalization=[1, 0],
        matrices=[pmp_writer.PositiveMatrixWithPrefactor(
            prefactor=pmp_writer.DampedRational(
                constant=1, base="0.36787944117144233", poles=[]),
            polynomials=rows)])


def test_three_by_three_is_refused(tmp_path):
    _three_by_three(tmp_path / "pmp.json")
    for main in (jax_pmp2functions.main, pmp2functions.main):
        with pytest.raises(ValueError, match="Only 1x1 and 2x2 supported: 3"):
            main(["-p", "128", "-i", str(tmp_path / "pmp.json"),
                  "-o", str(tmp_path / "f.json")])


def test_missing_arguments_exit_2(capsys):
    assert pmp2functions.main(["-p", "128"]) == 2
    assert "required" in capsys.readouterr().err
