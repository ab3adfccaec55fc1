"""Per-block costs, ``ck/block_timings`` and the LPT bin packing of the
JAX package's ``solver/placement.py``.

The reference maps blocks to process groups by cost
(`sdpb_util/block_mapping/compute_block_grid_mapping.hxx`), with costs
from a measured timing run written to ``ck/block_timings`` and read
back on restart (`Block_Info/read_block_costs.cxx`, `write_timing.cxx`).
As in the JAX package, the costs here come from a flop model: within a
bucket every block runs the same batched code, so a measurement could
only give the bucket's time over its block count.  The file keeps the
reference's format (one integer per block, in block order), so a later
multi-device run can read it.

The LPT half (`blas_jobs/LPT_scheduling.hxx`) spreads work items over
bins: ``spectrum`` deals its blocks to worker processes with
``lpt_assign``; ``bucket_device_permutation`` and ``bucket_loads`` are
the block-to-device mapping of a bucket sharded over several devices.
"""

from __future__ import annotations

import pathlib

import numpy as np


def lpt_assign(costs, n_bins: int, capacity: int | None = None):
    """Longest-Processing-Time-first assignment of items to bins: items
    by descending cost (stable), each into the least-loaded bin that
    holds fewer than ``capacity`` items.  Returns (bin of each item as
    an int array, bin loads as a float array)."""
    costs = np.asarray(costs, dtype=np.float64)
    order = np.argsort(-costs, kind="stable")
    bin_of = np.zeros(len(costs), dtype=np.int64)
    loads = np.zeros(n_bins, dtype=np.float64)
    counts = np.zeros(n_bins, dtype=np.int64)
    for i in order:
        eligible = np.arange(n_bins) if capacity is None else \
            np.nonzero(counts < capacity)[0]
        b = eligible[np.argmin(loads[eligible])]
        bin_of[i] = b
        loads[b] += costs[i]
        counts[b] += 1
    return bin_of, loads


def imbalance(loads) -> float:
    """(max - mean) / mean of the bin loads, 0 for perfect balance."""
    loads = np.asarray(loads, dtype=np.float64)
    mean = loads.mean()
    if mean == 0:
        return 0.0
    return float((loads.max() - mean) / mean)


def bucket_device_permutation(costs, n_devices: int):
    """Order of one bucket's blocks so that contiguous per-device chunks
    of ceil(nb / n_devices) slots are LPT-balanced: each device's group
    is padded to exactly that many slots with -1 (a phantom block), so
    chunk boundaries always fall between LPT bins.  Returns (slots, an
    int array of per_dev * n_devices entries, and the bin loads)."""
    costs = np.asarray(costs, dtype=np.float64)
    per_dev = -(-len(costs) // n_devices)
    bin_of, loads = lpt_assign(costs, n_devices, capacity=per_dev)
    slots = np.full(per_dev * n_devices, -1, dtype=np.int64)
    for d in range(n_devices):
        mine = np.nonzero(bin_of == d)[0]
        slots[d * per_dev: d * per_dev + len(mine)] = mine
    return slots, loads


def read_block_costs(ck_dir, sdp_dir, num_blocks: int, problem=None):
    """Per-block costs: ``ck/block_timings`` if present (one integer per
    line, block order), else the flop model when ``problem`` is given,
    else the block_data file sizes, else uniform
    (`Block_Info/read_block_costs.cxx:13`)."""
    ck_dir = pathlib.Path(ck_dir) if ck_dir else None
    if ck_dir is not None:
        f = ck_dir / "block_timings"
        if f.exists():
            vals = [int(line) for line in f.read_text().split()]
            if len(vals) == num_blocks:
                return np.asarray(vals, dtype=np.float64)
    if problem is not None:
        return flop_model_costs(problem)
    sdp_dir = pathlib.Path(sdp_dir) if sdp_dir else None
    if sdp_dir is not None and sdp_dir.is_dir():
        sizes = []
        for j in range(num_blocks):
            for suffix in (".bin", ".json"):
                f = sdp_dir / f"block_data_{j}{suffix}"
                if f.exists():
                    sizes.append(f.stat().st_size)
                    break
            else:
                sizes = None
                break
        if sizes:
            return np.asarray(sizes, dtype=np.float64)
    return np.ones(num_blocks, dtype=np.float64)


def write_block_timings(ck_dir, problem, costs) -> None:
    """``ck/block_timings`` from per-bucket costs in seconds
    (``costs[i][pos]`` for block ``problem.buckets[i].block_indices[pos]``):
    one integer, microseconds, per block in block order
    (`write_timing.cxx`)."""
    pairs = []
    for bi, bk in enumerate(problem.buckets):
        for pos, j in enumerate(bk.block_indices):
            pairs.append((j, costs[bi][pos]))
    pairs.sort()
    _write(ck_dir, (c * 1e6 for _, c in pairs))


def write_flop_model_timings(ck_dir, problem) -> None:
    """``ck/block_timings`` from the flop model, as the ``sdpb`` CLI
    writes it after every solve."""
    _write(ck_dir, flop_model_costs(problem))


def _write(ck_dir, values) -> None:
    ck_dir = pathlib.Path(ck_dir)
    ck_dir.mkdir(parents=True, exist_ok=True)
    (ck_dir / "block_timings").write_text(
        "\n".join(str(max(1, int(v))) for v in values) + "\n")


def flop_model_cost_of(shape, dual_dim: int) -> float:
    """The per-iteration O(n^3) terms of one block: the Schur
    Cholesky and solves, the bilinear pairings and the XY products
    (`run.cxx` phase structure)."""
    s_ = shape.schur_size
    he, ho = shape.he, shape.ho
    m, pts = shape.m, shape.pts
    return float(s_ ** 3 + 2 * s_ * s_ * dual_dim
                 + 2 * (m * he) ** 3 + 2 * (m * ho) ** 3
                 + 2 * (m * pts) * (m * he) ** 2
                 + 2 * (m * pts) * (m * ho) ** 2)


def flop_model_costs(problem):
    """Per-block costs in block order for a BucketedProblem."""
    costs = np.zeros(problem.num_blocks, dtype=np.float64)
    for bk in problem.buckets:
        c = flop_model_cost_of(bk.shape, problem.dual_dim)
        for j in bk.block_indices:
            costs[j] = c
    return costs


def bucket_loads(problem, costs, n_devices: int):
    """Per-device loads of buckets sharded over ``n_devices``: each
    bucket pads to ceil(nb / n_devices) blocks a device, and a phantom
    block costs as much as a real one.  ``costs`` is unused, as in the
    JAX package: a bucket's blocks all cost its flop model."""
    loads = np.zeros(n_devices, dtype=np.float64)
    for bk in problem.buckets:
        per_dev = -(-bk.nb // n_devices) if bk.nb else 0
        loads += per_dev * flop_model_cost_of(bk.shape, problem.dual_dim)
    return loads
