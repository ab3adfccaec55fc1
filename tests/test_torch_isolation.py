"""The port stands alone: no file of sdpb_tpu_torch/ and neither
chip_smoke.py imports jax or sdpb_tpu, and its entry points run on the
CUDA device unless told otherwise, never falling back to the CPU."""

import ast
import importlib.util
import pathlib

import pytest
import torch

from sdpb_tpu_torch import device as devmod
from sdpb_tpu_torch.apps import sdpb as app

from torch_port_util import one_torch_thread  # noqa: F401,E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "sdpb_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "compare_column_loops.py"]
# the port's native sources: none may name the JAX package's library
PORT_SOURCES = sorted(
    p for p in (ROOT / "sdpb_tpu_torch" / "csrc").iterdir()
    if p.suffix in (".cpp", ".cu", ".cuh"))
SDP_1D = ROOT / "sdpb_tpu_torch" / "data" / "quickstart_1d_sdp"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "sdpb_tpu"), (path, name)
    assert "libsdpb_tpu" not in path.read_text(), path


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_native_sources_are_the_ports_own(path):
    assert "libsdpb_tpu" not in path.read_text(), path


def test_port_sources_cover_the_codec_and_the_root_scripts():
    names = {p.name for p in PORT_SOURCES}
    assert "codec.cpp" in names and "expansion_chol.cu" in names
    assert ROOT / "compare_column_loops.py" in PORT_FILES


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devmod.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["-s", str(SDP_1D), "--noFinalCheckpoint"])
    assert devmod.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert devmod.resolve_device(None) == torch.device("cuda", 0)


def test_missing_options_exit_nonzero(tmp_path, capsys, monkeypatch):
    """Several visible CUDA devices no longer exit 2 for a missing
    module: sdpb starts one rank per GPU (parallel/multihost.py's
    launch_local, test_torch_multigpu_cli.py) before anything touches a
    card, and returns the ranks' exit code, non-zero when a rank
    failed.  The float64-expansion format (--device cpu) is ported
    (test_torch_solver_expansion.py), as are checkpoints,
    --checkpointInterval and restarts (test_torch_checkpoint.py); a
    --precision above the largest kernel class is refused at startup
    (test_torch_memory.py)."""
    from sdpb_tpu_torch.parallel import multihost

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(multihost, "launch_local",
                        lambda module, argv, n: calls.append(n) or 1)
    for key in ("RANK", "WORLD_SIZE", "SDPB_COORDINATOR"):
        monkeypatch.delenv(key, raising=False)
    base = ["-s", str(SDP_1D), "-o", str(tmp_path / "out")]
    assert app.main(base + ["--noFinalCheckpoint"]) == 1
    assert app.main(base + ["--device", "cuda", "--checkpointInterval",
                            "10"]) == 1
    assert calls == [2, 2]
    assert not (tmp_path / "out").exists()


def test_chip_smoke_needs_a_card(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_kernel_wrappers_refuse_other_devices():
    from sdpb_tpu_torch.ops import expansion_kernels as ek
    from sdpb_tpu_torch.ops import limb_kernels as lk

    a = torch.zeros(1, 2, 2, 5, device="meta")
    with pytest.raises(ValueError):
        lk.cholesky_unblocked_batched(a)
    e = torch.zeros(3, 4, dtype=torch.float64, device="meta")
    for fn in (ek.exp_add, ek.exp_mul, ek.exp_div):
        with pytest.raises(ValueError):
            fn(e, e)


def _outer_limits_argv(tmp_path, precision):
    from sdpb_tpu_torch.apps import pmp2functions
    from sdpb_tpu_torch.io import pmp_writer

    pmp_writer.write_pmp_json(
        tmp_path / "pmp.json", objective=[0, -1], normalization=[1, 0],
        matrices=[pmp_writer.PositiveMatrixWithPrefactor(
            prefactor=pmp_writer.DampedRational(
                constant=1, base="0.36787944117144233", poles=[]),
            polynomials=[[[[1, 0, 0, 0, 1], [0, 0, 1, 0, "1/12"]]]])])
    assert pmp2functions.main(["-p", "128", "-i", str(tmp_path / "pmp.json"),
                               "-o", str(tmp_path / "f.json"),
                               "-v", "0"]) == 0
    (tmp_path / "points.json").write_text('{"points": [["0", "1", "4"]]}')
    return ["--functions", str(tmp_path / "f.json"), "--points",
            str(tmp_path / "points.json"), "--precision", str(precision),
            "-o", str(tmp_path / "out.json")]


def test_tools_need_a_card_where_they_touch_one(tmp_path, monkeypatch):
    """outer_limits solves on the card and raises without one (unless
    told "cpu"); pmp2functions and spectrum are host tools and run
    without a card (test_torch_spectrum.py::test_host_only)."""
    from sdpb_tpu_torch.apps import outer_limits

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _outer_limits_argv(tmp_path, 128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        outer_limits.main(argv)
    assert not (tmp_path / "out.json").exists()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_outer_limits_exits_2_above_the_prime_pool(tmp_path, monkeypatch,
                                                   capsys, device):
    """--precision 3000 exits 2 at startup naming the prime pool's limit,
    on either device, before anything touches the card (on "cuda" no
    card is present here: the check comes first)."""
    from sdpb_tpu_torch.apps import outer_limits

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert outer_limits.main(_outer_limits_argv(tmp_path, 3000),
                             device=device) == 2
    err = capsys.readouterr().err
    assert "prime pool" in err and "largest precision it takes is" in err
    assert not (tmp_path / "out.json").exists()


def test_the_parallel_modules_are_ported():
    """sdpb_tpu/parallel/ has its counterpart in sdpb_tpu_torch/parallel/
    (the JAX package's _shard.py is comm.py there), each standing alone
    (test_no_jax_or_reference_package_imports covers them), and the
    memory estimate counts several devices."""
    import inspect

    from sdpb_tpu_torch.solver import memory

    names = {p.stem for p in (ROOT / "sdpb_tpu_torch" / "parallel")
             .glob("*.py")}
    assert {"comm", "multihost", "mesh", "dist_q", "intra", "intra_solver",
            "bucketed"} <= names
    assert {p.stem for p in (ROOT / "sdpb_tpu" / "parallel").glob("*.py")} \
        - {"_shard", "__init__"} <= names
    for fn in (memory.estimate_solver_memory, memory.check_memory_limit):
        assert "n_devices" in inspect.signature(fn).parameters
    assert callable(memory.intra_would_fit)
