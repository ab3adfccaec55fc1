"""Readers for the text solution format ("height width\\n" + decimals),
the inverse of output.write_vector/write_matrix; values come back as
float64 word expansions."""

from __future__ import annotations

import pathlib

import numpy as np

from ..mp import decimal as mpdec


def read_text_vector(path, k: int) -> np.ndarray:
    lines = pathlib.Path(path).read_text().split()
    h, w = int(lines[0]), int(lines[1])
    if w != 1 or len(lines) - 2 != h:
        raise ValueError(f"{path}: not an {h} x 1 vector")
    return np.stack([mpdec.from_decimal(v, k) for v in lines[2:]])


def read_text_matrix(path, k: int) -> np.ndarray:
    lines = pathlib.Path(path).read_text().split()
    h, w = int(lines[0]), int(lines[1])
    if len(lines) - 2 != h * w:
        raise ValueError(f"{path}: not an {h} x {w} matrix")
    out = np.stack([mpdec.from_decimal(v, k) for v in lines[2:]])
    return out.reshape(h, w, k)
