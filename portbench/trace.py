"""What the traced run records from the benchmark's own files: spans
around the calls into the program's layers, the shape of each call of
the hand-written kernels, and the device's operations from
torch.profiler.

Spans and kernel calls are recorded by wrapping module attributes of the
program (the program calls its phases and kernels through them) while
the profiler runs, and restored afterwards.
"""

from __future__ import annotations

import contextlib
import re
import time

from . import opcounts as oc

# The phases of one step, as ``solver/bucket_iteration.compute_step``
# calls them; a gap outside every span is solver/driver.py's own host
# work.
STEP_PHASES = ("schur_factorize", "compute_xy_mu", "search_direction",
               "corrector_beta", "pair_products", "apply_step",
               "conditions")


@contextlib.contextmanager
def _patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


class Spans:
    """Host spans (name, start_ns, stop_ns) on the perf_counter clock,
    recorded while the program's functions are wrapped."""

    def __init__(self):
        self.spans = []

    def wrap(self, label, fn):
        def inner(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spans.append((label, t0, time.perf_counter_ns()))
        return inner

    @contextlib.contextmanager
    def around_program(self):
        from sdpb_tpu_torch.solver import bucket_iteration as bit

        with contextlib.ExitStack() as stack:
            stack.enter_context(_patched(
                bit, "compute_residues",
                lambda f: self.wrap("residues", f)))
            stack.enter_context(_patched(
                bit, "compute_step", lambda f: self.wrap("step", f)))
            for name in STEP_PHASES:
                stack.enter_context(_patched(
                    bit, name,
                    lambda f, name=name: self.wrap(f"step.{name}", f)))
            yield self

    def labels_at(self, times):
        """The innermost span open at each of ``times`` (ascending), or
        "driver" outside every span: one sweep over the spans by start."""
        spans = sorted(self.spans, key=lambda s: s[1])
        out, active, i = [], [], 0
        for t in times:
            while i < len(spans) and spans[i][1] <= t:
                active.append(spans[i])
                i += 1
            active = [s for s in active if s[2] > t]
            out.append(max(active, key=lambda s: s[1])[0] if active
                       else "driver")
        return out


class KernelCalls:
    """Each call of the hand-written limb kernels while they are wrapped:
    its least time on the card from its shapes (``opcounts``)."""

    def __init__(self):
        self.least_s = 0.0
        self.calls = 0

    def _add(self, nbytes, ops):
        self.least_s += oc.least_seconds(nbytes, ops, oc.PEAK_F32_PER_S)
        self.calls += 1

    @contextlib.contextmanager
    def recording(self):
        from sdpb_tpu_torch.ops import limb_kernels as lk

        def limb_chol(f):
            def inner(a):
                if a.is_cuda and a.numel():
                    bb, n, _, S = a.shape
                    L = S - 1
                    self._add(2 * a.numel() * 4,
                              oc.chol_ops(bb, n, L, oc.limb_newton_steps(L)))
                return f(a)
            return inner

        def limb_solve(f):
            def inner(l, b, inv_d, transpose=False):
                if b.is_cuda and b.numel():
                    BB, n, m, S = b.shape
                    nbytes = (l.numel() + 2 * b.numel() + inv_d.numel()) * 4
                    self._add(nbytes, oc.solve_ops(BB, n, m, S - 1))
                return f(l, b, inv_d, transpose)
            return inner

        def limb_elementwise(name, f):
            def inner(a, b):
                if a.is_cuda:
                    S = a.shape[-1]
                    n = _values(a, b)
                    if n:
                        nbytes = (a.numel() + b.numel() + n * S) * 4
                        self._add(nbytes,
                                  n * oc.limb_elementwise_ops(name, S - 1))
                return f(a, b)
            return inner

        with contextlib.ExitStack() as stack:
            p = lambda mod, name, make: stack.enter_context(
                _patched(mod, name, make))
            p(lk, "cholesky_unblocked_batched", limb_chol)
            p(lk, "solve_unblocked_batched", limb_solve)
            for name in ("limb_add", "limb_mul", "limb_div"):
                p(lk, name, lambda f, name=name: limb_elementwise(name, f))
            yield self


def _values(a, b) -> int:
    """Values of an elementwise call's batch."""
    import torch

    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    n = 1
    for d in batch:
        n *= d
    return n


# ---------------------------------------------------------------------------
# The device trace
# ---------------------------------------------------------------------------

MARKER = re.compile(r"spin_kernel")


class DeviceTrace:
    """The device operations of a profiled window, (name, start_ns,
    stop_ns) on the profiler's clock, sorted by start; their device
    time and count by name; and the clock's offset from the host's
    perf_counter_ns."""

    def __init__(self, prof, host_mark_ns: int):
        from torch.autograd import DeviceType

        ops = []
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            t0 = ev.start_ns()
            ops.append((ev.name(), t0, t0 + ev.duration_ns()))
        ops.sort(key=lambda o: o[1])
        marks = [o for o in ops if MARKER.search(o[0])]
        # the marker kernel ran right after the host read host_mark_ns,
        # on an idle device: it ties the two clocks
        self.offset = (marks[0][1] - host_mark_ns) if marks else None
        self.ops = [o for o in ops if not MARKER.search(o[0])]
        self.per_name = {}
        for name, t0, t1 in self.ops:
            ns, n = self.per_name.get(name, (0, 0))
            self.per_name[name] = (ns + t1 - t0, n + 1)

    @staticmethod
    def is_kernel(name: str) -> bool:
        return not name.startswith(("Memcpy", "Memset"))

    def kernel_launches(self) -> int:
        return sum(n for name, (_, n) in self.per_name.items()
                   if self.is_kernel(name))

    def busy_ns(self) -> int:
        """Length of the union of the operations' intervals."""
        busy, end = 0, None
        for _, t0, t1 in self.ops:
            if end is None or t0 >= end:
                busy += t1 - t0
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        return busy

    def gaps(self, start_ns: int, stop_ns: int):
        """Idle intervals (t0, t1) of the device within [start, stop]."""
        out, cur = [], start_ns
        for _, t0, t1 in self.ops:
            if t0 > cur:
                out.append((cur, min(t0, stop_ns)))
            cur = max(cur, t1)
            if cur >= stop_ns:
                break
        if cur < stop_ns:
            out.append((cur, stop_ns))
        return [g for g in out if g[1] > g[0]]

    def by_name(self, pattern: str) -> tuple:
        """(device seconds, launches) of the kernels matching ``pattern``."""
        rx = re.compile(pattern)
        ns = n = 0
        for name, (t, k) in self.per_name.items():
            if self.is_kernel(name) and rx.search(name):
                ns += t
                n += k
        return ns / 1e9, n

    def by_class(self) -> dict:
        """Device seconds by ``opcounts.PROFILE_CLASSES`` (first match)."""
        out = {}
        for name, (t, _) in self.per_name.items():
            if not self.is_kernel(name):
                continue
            cls = next((c for c, pat in oc.PROFILE_CLASSES
                        if re.search(pat, name)), "other")
            out[cls] = out.get(cls, 0.0) + t / 1e9
        return out

    def top_ops(self, n: int = 10):
        """The ``n`` operations that took most device time, summed by
        name."""
        tot = sorted(self.per_name.items(), key=lambda kv: -kv[1][0])
        return [(name, t / 1e9) for name, (t, _) in tot[:n]]
