"""Solver parameters, mirroring the reference flag schema and defaults
(`src/sdp_solve/Solver_Parameters/Solver_Parameters.cxx:10-157`).
Thresholds are decimal strings, converted exactly to MP constants of
the word format: base-2^9 limbs ("float32", the card's default) or
float64 word expansions ("float64")."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import torch

from ..mp import core as mpcore
from ..mp import decimal as mpdec
from ..mp import limb
from .memory import parse_bytes


@dataclasses.dataclass(frozen=True)
class SolverParams:
    precision: int = 400
    max_iterations: int = 500
    max_runtime: float = float(2 ** 63)
    checkpoint_interval: float = 3600.0
    duality_gap_threshold: str = "1e-30"
    primal_error_threshold: str = "1e-30"
    dual_error_threshold: str = "1e-30"
    initial_matrix_scale_primal: str = "1e20"
    initial_matrix_scale_dual: str = "1e20"
    feasible_centering_parameter: str = "0.1"
    infeasible_centering_parameter: str = "0.3"
    step_length_reduction: float = 0.7
    min_primal_step: str = "0"
    min_dual_step: str = "0"
    max_complementarity: str = "1e100"
    find_primal_feasible: bool = False
    find_dual_feasible: bool = False
    detect_primal_feasible_jump: bool = False
    detect_dual_feasible_jump: bool = False
    # --maxSharedMemory: byte cap on the Q residue pipeline's buffers
    max_shared_memory: str = "0"
    # The MP word format: "float32" limbs (the card's default) or
    # "float64" word expansions (sdpb --device cpu, as in sdpb_tpu).
    word_dtype: str = "float32"

    @property
    def max_shared_memory_bytes(self) -> int:
        return parse_bytes(self.max_shared_memory)

    @property
    def dtype(self) -> torch.dtype:
        return mpcore.torch_dtype(self.word_dtype)

    @property
    def n_words(self) -> int:
        """Trailing-axis size of the MP arrays of ``word_dtype``: limb
        slots, or float64 words of 53 bits each."""
        if self.dtype == torch.float32:
            return limb.slots_for_precision(self.precision)
        return max(2, -(-self.precision // 53))

    @property
    def n_read_words(self) -> int:
        """float64 words that carry ``precision`` bits while reading
        (one more than the expansion format's, for the limb path's
        exact conversion)."""
        if self.dtype == torch.float64:
            return self.n_words
        return max(2, -(-self.precision // 53)) + 1

    @functools.lru_cache(maxsize=None)
    def mpconst(self, decimal: str) -> np.ndarray:
        """The decimal as an MP constant of ``word_dtype``."""
        words = mpdec.from_decimal(decimal, self.n_read_words)
        if self.dtype == torch.float64:
            return words
        return limb.from_words_np(words, self.n_words)

    def max_complementarity_mp(self):
        return self.mpconst(self.max_complementarity)

    def feasible_centering_mp(self):
        return self.mpconst(self.feasible_centering_parameter)

    def infeasible_centering_mp(self):
        return self.mpconst(self.infeasible_centering_parameter)

    def predictor_beta(self, is_primal_and_dual_feasible: bool):
        """0 if feasible, else the infeasible centering parameter."""
        if is_primal_and_dual_feasible:
            return np.zeros((self.n_words,),
                            dtype=np.float32 if self.dtype == torch.float32
                            else np.float64)
        return self.infeasible_centering_mp()

    def _mpf(self, decimal: str):
        import mpmath

        ctx = mpmath.mp.clone()
        ctx.prec = self.precision + 64
        return ctx.mpf(decimal)

    def thresholds_mpf(self):
        return {
            "duality_gap": self._mpf(self.duality_gap_threshold),
            "primal_error": self._mpf(self.primal_error_threshold),
            "dual_error": self._mpf(self.dual_error_threshold),
            "min_primal_step": self._mpf(self.min_primal_step),
            "min_dual_step": self._mpf(self.min_dual_step),
        }
