"""Reader for the reference SDP on-disk directory format (JSON flavor).

Format spec: the reference's docs/SDPB_input_format.md and writer at
`src/pmp2sdp/write_sdp.cxx:246`.  A directory (or zip) contains:

- ``control.json``      {num_blocks, command}
- ``objectives.json``   {constant, b: [N decimal strings]}
- ``normalization.json``(optional) {normalization: [N+1 strings]}
- ``block_info_<i>.json``  {dim, num_points}
- ``block_data_<i>.json``  {bilinear_bases_even/odd, c, B}

All numbers are full-precision decimal strings, parsed into K-word
float64 expansions exactly (mpmath splitting); the solver converts
those into limbs.  (The port's copy of sdpb_tpu/io/sdp_json.py.)
"""

from __future__ import annotations

import dataclasses
import json
import zipfile
from pathlib import Path

import numpy as np

from ..mp import decimal as mpdec


@dataclasses.dataclass
class RawBlock:
    dim: int
    num_points: int
    bilinear_bases_even: np.ndarray  # (he, pts, K)
    bilinear_bases_odd: np.ndarray   # (ho, pts, K)
    c: np.ndarray                    # (schur_size, K)
    B: np.ndarray                    # (schur_size, N, K)


@dataclasses.dataclass
class RawSDP:
    objective_const: np.ndarray      # (K,)
    b: np.ndarray                    # (N, K)
    normalization: list[str] | None
    blocks: list[RawBlock]
    command: str = ""

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def dual_dim(self) -> int:
        return self.b.shape[0]


class _DirOrZip:
    """Uniform file access for an SDP directory or .zip archive."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.zf = zipfile.ZipFile(self.path) if self.path.suffix == ".zip" \
            else None

    def read_json(self, name: str):
        if self.zf is not None:
            with self.zf.open(name) as f:
                return json.load(f)
        return json.loads((self.path / name).read_text())

    def read_bytes(self, name: str) -> bytes:
        if self.zf is not None:
            with self.zf.open(name) as f:
                return f.read()
        return (self.path / name).read_bytes()

    def exists(self, name: str) -> bool:
        if self.zf is not None:
            return name in self.zf.namelist()
        return (self.path / name).exists()


def _arr(strings, k) -> np.ndarray:
    return mpdec.array_from_decimal(strings, k)


def read_sdp(path, k: int = 4) -> RawSDP:
    """Load an SDP directory/zip into MP word arrays with K words."""
    src = _DirOrZip(Path(path))
    control = src.read_json("control.json")
    objectives = src.read_json("objectives.json")
    num_blocks = control["num_blocks"]

    normalization = None
    if src.exists("normalization.json"):
        normalization = src.read_json("normalization.json")["normalization"]

    blocks = []
    for i in range(num_blocks):
        info = src.read_json(f"block_info_{i}.json")
        dim, pts = info["dim"], info["num_points"]
        if src.exists(f"block_data_{i}.json"):
            data = src.read_json(f"block_data_{i}.json")
            q_even = _arr(data["bilinear_bases_even"], k)
            q_odd = _arr(data["bilinear_bases_odd"], k)
            c = _arr(data["c"], k)
            B = _arr(data["B"], k)
        else:
            # binary block format (the reference's default,
            # `write_block_data.cxx` / `read_block_data.cxx:17-20`)
            from .sdp_bin import read_block_data_bin

            data = read_block_data_bin(
                src.read_bytes(f"block_data_{i}.bin"), k)
            q_even = data["bilinear_bases_even"]
            q_odd = data["bilinear_bases_odd"]
            c = data["c"]
            B = data["B"]
        schur = pts * dim * (dim + 1) // 2
        assert c.shape[0] == schur, (c.shape, schur)
        assert q_even.shape[:2] == ((pts - 1) // 2 + 1, pts)
        blocks.append(RawBlock(dim, pts, q_even, q_odd, c, B))

    return RawSDP(
        objective_const=mpdec.from_decimal(str(objectives["constant"]), k),
        b=_arr(objectives["b"], k),
        normalization=normalization,
        blocks=blocks,
        command=control.get("command", ""),
    )
