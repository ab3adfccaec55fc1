"""Solver-side problem containers: limb tensors grouped into buckets.

Index conventions (`SDP.hxx:49-80`, as in the JAX package):
- constraint tuples p <-> (j, r, s, k), 0 <= r <= s < m_j, 0 <= k < pts_j,
  flattened as p_local = (s(s+1)/2 + r) * pts + k
- two PSD parity blocks per j: even basis height he = (pts-1)//2 + 1,
  odd ho = pts - he; PSD block size m * h_parity.

A bucket stacks the blocks of one shape on a leading axis; every solver
phase runs per bucket on that batch axis (the JAX package vmaps its
per-block kernels over the same axis).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mp import limb


@dataclasses.dataclass(frozen=True)
class BlockShape:
    """Static shape metadata for one PMP constraint block."""

    m: int
    pts: int
    he: int
    ho: int

    @property
    def n_tuples(self) -> int:
        return self.m * (self.m + 1) // 2

    @property
    def schur_size(self) -> int:
        return self.n_tuples * self.pts

    def psd_size(self, parity: int) -> int:
        return self.m * (self.he if parity == 0 else self.ho)

    @property
    def psd_sizes(self):
        return (self.psd_size(0), self.psd_size(1))

    def tuple_indices(self):
        """(s_idx, r_idx) of the n_tuples tuples t = s(s+1)/2 + r."""
        s_idx, r_idx = [], []
        for s in range(self.m):
            for r in range(s + 1):
                s_idx.append(s)
                r_idx.append(r)
        return np.array(s_idx), np.array(r_idx)


def block_shape_of(dim: int, pts: int) -> BlockShape:
    he = (pts - 1) // 2 + 1
    return BlockShape(m=dim, pts=pts, he=he, ho=pts - he)


def build_u(q: np.ndarray, m: int) -> np.ndarray:
    """Block-diagonal bases block U = I_m (x) q, shape (m*h, m*pts, K)."""
    h, pts, k = q.shape
    u = np.zeros((m, h, m, pts, k), dtype=q.dtype)
    for i in range(m):
        u[i, :, i, :, :] = q
    return u.reshape(m * h, m * pts, k)


@dataclasses.dataclass
class SDPBucket:
    """nb same-shape blocks stacked on a leading axis."""

    c: torch.Tensor          # (nb, schur, S)
    B: torch.Tensor          # (nb, schur, N, S)
    q: tuple                 # ((nb, he, pts, S), (nb, ho, pts, S))
    u: tuple                 # ((nb, m*he, m*pts, S), ...)
    shape: BlockShape
    block_indices: tuple = ()

    @property
    def nb(self) -> int:
        return self.c.shape[0]


@dataclasses.dataclass
class BucketedProblem:
    objective_const: torch.Tensor   # (S,)
    b: torch.Tensor                 # (N, S)
    buckets: list

    @property
    def dual_dim(self):
        return self.b.shape[0]

    @property
    def num_blocks(self):
        return sum(bk.nb for bk in self.buckets)

    @property
    def total_psd_rows(self):
        return sum(bk.nb * sum(bk.shape.psd_sizes) for bk in self.buckets)

    @property
    def k(self) -> int:
        return self.b.shape[-1]

    @property
    def device(self):
        return self.b.device


@dataclasses.dataclass
class BucketedState:
    """Iterate (x, y, X, Y) with per-bucket stacked blocks."""

    x: list       # [(nb, schur, S)]
    y: torch.Tensor
    X: list       # [((nb, se, se, S), (nb, so, so, S))]
    Y: list

    def block_x(self, problem: BucketedProblem, j: int):
        bi, pos = _locate(problem, j)
        return self.x[bi][pos]

    def block_XY(self, problem: BucketedProblem, j: int, which: str = "X"):
        bi, pos = _locate(problem, j)
        mats = self.X if which == "X" else self.Y
        return tuple(mats[bi][p][pos] for p in range(2))


def _locate(problem: BucketedProblem, j: int):
    for bi, bk in enumerate(problem.buckets):
        if j in bk.block_indices:
            return bi, bk.block_indices.index(j)
    raise KeyError(j)


def raw_to_limbs(raw, k: int):
    """Convert a RawSDP's float64-word arrays into k-slot limb arrays
    (host, numpy-exact): sdpb_tpu's ``raw_to_dtype`` for float32."""
    import copy

    conv = lambda a: limb.from_words_np(np.asarray(a), k)
    out = copy.copy(raw)
    out.objective_const = conv(raw.objective_const)
    out.b = conv(raw.b)
    out.blocks = [
        dataclasses.replace(
            rb, bilinear_bases_even=conv(rb.bilinear_bases_even),
            bilinear_bases_odd=conv(rb.bilinear_bases_odd),
            c=conv(rb.c), B=conv(rb.B))
        for rb in raw.blocks]
    return out


def group_blocks(raw) -> dict:
    """{BlockShape: [block indices]} of a RawSDP, in first-appearance
    order (sdpb_tpu's ``bucketize``)."""
    groups: dict = {}
    for j, rb in enumerate(raw.blocks):
        shape = block_shape_of(rb.dim, rb.num_points)
        if (rb.bilinear_bases_even.shape[0], rb.bilinear_bases_odd.shape[0]) \
                != (shape.he, shape.ho):
            raise ValueError(f"block {j}: bilinear bases of heights "
                             f"{rb.bilinear_bases_even.shape[0]}, "
                             f"{rb.bilinear_bases_odd.shape[0]} do not fit "
                             f"{rb.num_points} points")
        groups.setdefault(shape, []).append(j)
    return groups


def bucketed_problem_from_raw(raw, k: int, device) -> BucketedProblem:
    """RawSDP (io/sdp_json.py) -> limb BucketedProblem on ``device``:
    blocks grouped by shape, in first-appearance order (sdpb_tpu's
    ``problem_from_raw`` followed by ``bucketize``)."""
    groups = group_blocks(raw)
    lraw = raw_to_limbs(raw, k)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    buckets = []
    for shape, idxs in groups.items():
        blocks = [lraw.blocks[j] for j in idxs]
        qe = np.stack([rb.bilinear_bases_even for rb in blocks])
        qo = np.stack([rb.bilinear_bases_odd for rb in blocks])
        buckets.append(SDPBucket(
            c=t(np.stack([rb.c for rb in blocks])),
            B=t(np.stack([rb.B for rb in blocks])),
            q=(t(qe), t(qo)),
            u=(t(np.stack([build_u(q, shape.m) for q in qe])),
               t(np.stack([build_u(q, shape.m) for q in qo]))),
            shape=shape, block_indices=tuple(idxs)))
    return BucketedProblem(objective_const=t(lraw.objective_const),
                           b=t(lraw.b), buckets=buckets)


def initial_bucketed_state(problem: BucketedProblem, scale_primal,
                           scale_dual) -> BucketedState:
    """Cold start x = y = 0, X = Omega_p I, Y = Omega_d I."""
    k = problem.k
    dev = problem.device

    def eye(nb, n, scale):
        m = torch.zeros((nb, n, n, k), dtype=torch.float32, device=dev)
        if n:
            idx = torch.arange(n, device=dev)
            m[:, idx, idx, :] = torch.as_tensor(
                limb.from_f64_np(float(scale), k), device=dev)
        return m

    x, X, Y = [], [], []
    for bk in problem.buckets:
        se, so = bk.shape.psd_sizes
        x.append(torch.zeros((bk.nb, bk.shape.schur_size, k),
                             dtype=torch.float32, device=dev))
        X.append((eye(bk.nb, se, scale_primal), eye(bk.nb, so, scale_primal)))
        Y.append((eye(bk.nb, se, scale_dual), eye(bk.nb, so, scale_dual)))
    y = torch.zeros((problem.dual_dim, k), dtype=torch.float32, device=dev)
    return BucketedState(x=x, y=y, X=X, Y=Y)


def bucketed_problem_from_arrays(arrays: dict, device):
    """Problem (and state, when present) from a flat dict of numpy limb
    arrays named after the dataclass fields -- how another
    implementation's problem and iterate are carried across:

      objective_const, b,
      buckets.<i>.{c, B, q.<p>, u.<p>, shape (m, pts), block_indices},
      x.<i>, y, X.<i>.<p>, Y.<i>.<p>           (state, optional)

    Returns (BucketedProblem, BucketedState or None); the arrays are
    copied."""
    t = lambda a: torch.tensor(np.asarray(a), device=device)
    n_buckets = len({key.split(".")[1] for key in arrays
                     if key.startswith("buckets.")})
    buckets = []
    for i in range(n_buckets):
        p = f"buckets.{i}."
        m, pts = (int(v) for v in arrays[p + "shape"])
        buckets.append(SDPBucket(
            c=t(arrays[p + "c"]), B=t(arrays[p + "B"]),
            q=(t(arrays[p + "q.0"]), t(arrays[p + "q.1"])),
            u=(t(arrays[p + "u.0"]), t(arrays[p + "u.1"])),
            shape=block_shape_of(m, pts),
            block_indices=tuple(int(v) for v in
                                arrays[p + "block_indices"])))
    problem = BucketedProblem(objective_const=t(arrays["objective_const"]),
                              b=t(arrays["b"]), buckets=buckets)
    if "y" not in arrays:
        return problem, None
    state = BucketedState(
        x=[t(arrays[f"x.{i}"]) for i in range(n_buckets)],
        y=t(arrays["y"]),
        X=[tuple(t(arrays[f"X.{i}.{p}"]) for p in range(2))
           for i in range(n_buckets)],
        Y=[tuple(t(arrays[f"Y.{i}.{p}"]) for p in range(2))
           for i in range(n_buckets)])
    return problem, state
