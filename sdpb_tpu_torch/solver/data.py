"""Solver-side problem containers: MP tensors (limbs or float64 word
expansions) per block, and grouped into buckets.

Index conventions (`SDP.hxx:49-80`, as in the JAX package):
- constraint tuples p <-> (j, r, s, k), 0 <= r <= s < m_j, 0 <= k < pts_j,
  flattened as p_local = (s(s+1)/2 + r) * pts + k
- two PSD parity blocks per j: even basis height he = (pts-1)//2 + 1,
  odd ho = pts - he; PSD block size m * h_parity.

A bucket stacks the blocks of one shape on a leading axis; every solver
phase runs per bucket on that batch axis (the JAX package vmaps its
per-block kernels over the same axis).  The unbucketed ``SDPProblem``
and ``SolverState`` (one entry per block) are the JAX package's
containers: ``approx_objective`` reads its problem as one and buckets
it for the solver's phases, and ``problem_from_arrays`` carries the
JAX package's problem and state across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mp import core as mpcore
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
class SDPBlock:
    """One block's problem data (``q`` the sampled bilinear bases, ``u``
    the block-diagonal bases blocks I_m (x) q)."""

    c: torch.Tensor          # (schur, K)
    B: torch.Tensor          # (schur, N, K)
    q: tuple                 # ((he, pts, K), (ho, pts, K))
    u: tuple                 # ((m*he, m*pts, K), ...)
    shape: BlockShape


@dataclasses.dataclass
class SDPProblem:
    objective_const: torch.Tensor   # (K,)
    b: torch.Tensor                 # (N, K)
    blocks: list                    # [SDPBlock]

    @property
    def dual_dim(self):
        return self.b.shape[0]

    @property
    def total_psd_rows(self):
        return sum(sum(bl.shape.psd_sizes) for bl in self.blocks)


@dataclasses.dataclass
class SolverState:
    """The iterate (x, y, X, Y), one entry per block; X and Y are parity
    pairs of dense matrices."""

    x: list
    y: torch.Tensor
    X: list
    Y: list


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

    #: the ranks a block-sharded problem's blocks are spread over, and
    #: each bucket's mask of real blocks (``parallel/mesh.py``'s
    #: MeshProblem); None on one device
    comm = None
    masks = None

    @property
    def bucket_sizes(self) -> list:
        """The real blocks of each bucket (over every rank)."""
        return [bk.nb for bk in self.buckets]

    @property
    def dual_dim(self):
        return self.b.shape[0]

    @property
    def num_blocks(self):
        return sum(self.bucket_sizes)

    @property
    def total_psd_rows(self):
        return sum(n * sum(bk.shape.psd_sizes)
                   for n, bk in zip(self.bucket_sizes, self.buckets))

    @property
    def k(self) -> int:
        return self.b.shape[-1]

    @property
    def dtype(self):
        return self.b.dtype

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


def raw_to_dtype(raw, k: int, dtype):
    """Convert a RawSDP's float64-word arrays to ``k`` slots of the
    format of ``dtype`` (host, numpy-exact): limbs for float32, a
    renormalized k-word expansion for float64."""
    if mpcore.torch_dtype(dtype) == torch.float32:
        return raw_to_limbs(raw, k)
    from ..mp import decimal as mpdec

    return _convert_raw(raw, lambda a: mpdec.words_to_dtype(
        np.asarray(a), k, np.float64))


def raw_to_limbs(raw, k: int):
    """Convert a RawSDP's float64-word arrays into k-slot limb arrays
    (host, numpy-exact): sdpb_tpu's ``raw_to_dtype`` for float32."""
    return _convert_raw(raw, lambda a: limb.from_words_np(np.asarray(a), k))


def _convert_raw(raw, conv):
    import copy

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


def _raw_in(raw, k: int, dtype):
    """The RawSDP in ``dtype``'s format at k slots: float64 words read
    at k words are taken as they are (as sdpb_tpu's problem_from_raw
    does), anything else converts exactly."""
    dtype = mpcore.torch_dtype(dtype)
    if dtype == torch.float64 and np.asarray(raw.b).dtype == np.float64 \
            and np.asarray(raw.b).shape[-1] == k:
        return raw
    return raw_to_dtype(raw, k, dtype)


def problem_from_raw(raw, device, dtype=torch.float64,
                     k: int | None = None) -> SDPProblem:
    """RawSDP -> unbucketed SDPProblem on ``device`` in ``dtype``'s
    format (k slots; default the raw word count)."""
    k = k if k is not None else np.asarray(raw.b).shape[-1]
    group_blocks(raw)               # checks the bases' heights
    craw = _raw_in(raw, k, dtype)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    blocks = []
    for rb in craw.blocks:
        shape = block_shape_of(rb.dim, rb.num_points)
        q = (rb.bilinear_bases_even, rb.bilinear_bases_odd)
        blocks.append(SDPBlock(c=t(rb.c), B=t(rb.B),
                               q=tuple(t(qp) for qp in q),
                               u=tuple(t(build_u(qp, shape.m)) for qp in q),
                               shape=shape))
    return SDPProblem(objective_const=t(craw.objective_const), b=t(craw.b),
                      blocks=blocks)


def _eye_scaled(batch, n: int, k: int, scale, dtype, device):
    m = torch.zeros((*batch, n, n, k), dtype=dtype, device=device)
    if n:
        idx = torch.arange(n, device=device)
        m[..., idx, idx, :] = torch.as_tensor(
            mpcore.from_f64_np(float(scale), k, dtype), device=device)
    return m


def initial_state(problem: SDPProblem, scale_primal,
                  scale_dual) -> SolverState:
    """Cold start x = y = 0, X = Omega_p I, Y = Omega_d I, per block."""
    k, dt, dev = problem.b.shape[-1], problem.b.dtype, problem.b.device
    x, X, Y = [], [], []
    for bl in problem.blocks:
        se, so = bl.shape.psd_sizes
        x.append(mpcore.zeros((bl.shape.schur_size,), k, dev, dt))
        X.append(tuple(_eye_scaled((), n, k, scale_primal, dt, dev)
                       for n in (se, so)))
        Y.append(tuple(_eye_scaled((), n, k, scale_dual, dt, dev)
                       for n in (se, so)))
    return SolverState(x=x, y=mpcore.zeros((problem.dual_dim,), k, dev, dt),
                       X=X, Y=Y)


def bucketize(problem: SDPProblem) -> BucketedProblem:
    """Group an SDPProblem's blocks by shape into stacked buckets, in
    first-appearance order."""
    groups: dict = {}
    for j, bl in enumerate(problem.blocks):
        groups.setdefault(bl.shape, []).append(j)
    buckets = []
    for shape, idxs in groups.items():
        bls = [problem.blocks[j] for j in idxs]
        buckets.append(SDPBucket(
            c=torch.stack([bl.c for bl in bls]),
            B=torch.stack([bl.B for bl in bls]),
            q=tuple(torch.stack([bl.q[p] for bl in bls]) for p in range(2)),
            u=tuple(torch.stack([bl.u[p] for bl in bls]) for p in range(2)),
            shape=shape, block_indices=tuple(idxs)))
    return BucketedProblem(objective_const=problem.objective_const,
                           b=problem.b, buckets=buckets)


def bucketed_problem_from_raw(raw, k: int, device,
                              dtype=torch.float32) -> BucketedProblem:
    """RawSDP (io/sdp_json.py) -> BucketedProblem on ``device`` in
    ``dtype``'s format: blocks grouped by shape, in first-appearance
    order (sdpb_tpu's ``problem_from_raw`` followed by ``bucketize``)."""
    return bucketize(problem_from_raw(raw, device, dtype, k))


def initial_bucketed_state(problem: BucketedProblem, scale_primal,
                           scale_dual) -> BucketedState:
    """Cold start x = y = 0, X = Omega_p I, Y = Omega_d I."""
    k, dt, dev = problem.k, problem.dtype, problem.device
    x, X, Y = [], [], []
    for bk in problem.buckets:
        se, so = bk.shape.psd_sizes
        x.append(mpcore.zeros((bk.nb, bk.shape.schur_size), k, dev, dt))
        X.append(tuple(_eye_scaled((bk.nb,), n, k, scale_primal, dt, dev)
                       for n in (se, so)))
        Y.append(tuple(_eye_scaled((bk.nb,), n, k, scale_dual, dt, dev)
                       for n in (se, so)))
    y = mpcore.zeros((problem.dual_dim,), k, dev, dt)
    return BucketedState(x=x, y=y, X=X, Y=Y)


def bucketed_problem_from_arrays(arrays: dict, device):
    """Problem (and state, when present) from a flat dict of numpy MP
    arrays (float32 limbs or float64 expansions) named after the
    dataclass fields -- how another implementation's problem and
    iterate are carried across:

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


def problem_from_arrays(arrays: dict, device):
    """Unbucketed problem (and state, when present) from a flat dict of
    numpy MP arrays named after the dataclass fields:

      objective_const, b, blocks.<j>.{c, B, q.<p>, u.<p>, shape (m, pts)},
      x.<j>, y, X.<j>.<p>, Y.<j>.<p>           (state, optional)

    Returns (SDPProblem, SolverState or None); the arrays are copied."""
    t = lambda a: torch.tensor(np.asarray(a), device=device)
    n_blocks = len({key.split(".")[1] for key in arrays
                    if key.startswith("blocks.")})
    blocks = []
    for j in range(n_blocks):
        p = f"blocks.{j}."
        m, pts = (int(v) for v in arrays[p + "shape"])
        blocks.append(SDPBlock(
            c=t(arrays[p + "c"]), B=t(arrays[p + "B"]),
            q=(t(arrays[p + "q.0"]), t(arrays[p + "q.1"])),
            u=(t(arrays[p + "u.0"]), t(arrays[p + "u.1"])),
            shape=block_shape_of(m, pts)))
    problem = SDPProblem(objective_const=t(arrays["objective_const"]),
                         b=t(arrays["b"]), blocks=blocks)
    if "y" not in arrays:
        return problem, None
    state = SolverState(
        x=[t(arrays[f"x.{j}"]) for j in range(n_blocks)], y=t(arrays["y"]),
        X=[tuple(t(arrays[f"X.{j}.{p}"]) for p in range(2))
           for j in range(n_blocks)],
        Y=[tuple(t(arrays[f"Y.{j}.{p}"]) for p in range(2))
           for j in range(n_blocks)])
    return problem, state
