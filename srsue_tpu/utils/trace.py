"""Per-TTI trace ring buffer with binary dump — parity with
``srslte::trace<T>`` (ue/hdr/common/trace.h:42-95: (tti, value) pairs,
binary file dump; used by phch_worker exec-time traces
phch_worker.cc:865-887) plus a context-manager stage timer that fills
the LOG_EXECTIME role (phch_worker.cc:140-142)."""

from __future__ import annotations

import struct
import time

import numpy as np


class Trace:
    def __init__(self, capacity: int = 1 << 14):
        self.tti = np.zeros(capacity, np.uint32)
        self.val = np.zeros(capacity, np.float32)
        self.n = 0
        self.capacity = capacity
        self.enabled = True

    def push(self, tti: int, value: float) -> None:
        if not self.enabled:
            return
        i = self.n % self.capacity
        self.tti[i] = tti
        self.val[i] = value
        self.n += 1

    def dump(self, path: str) -> None:
        """Binary dump: uint32 count, then (uint32 tti, float32 value)*."""
        k = min(self.n, self.capacity)
        with open(path, "wb") as f:
            f.write(struct.pack("<I", k))
            order = np.arange(self.n - k, self.n) % self.capacity
            rec = np.empty((k, 2), np.uint32)
            rec[:, 0] = self.tti[order]
            rec[:, 1] = self.val[order].view(np.uint32)
            f.write(rec.tobytes())

    @staticmethod
    def load(path: str):
        with open(path, "rb") as f:
            (k,) = struct.unpack("<I", f.read(4))
            rec = np.frombuffer(f.read(8 * k), np.uint32).reshape(k, 2)
        return rec[:, 0].copy(), rec[:, 1].copy().view(np.float32)


class StageTimer:
    """with StageTimer(trace, tti): ... — wall-clock stage timing in us
    (the tr_log_start/tr_log_end pattern)."""

    def __init__(self, trace: Trace, tti: int):
        self.trace = trace
        self.tti = tti

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.trace.push(self.tti, (time.perf_counter() - self.t0) * 1e6)
        return False


class XlaTrace:
    """Device-level profiling via the XLA profiler (jax.profiler) — the
    device upgrade of the reference's wall-clock exec-time traces
    (phch_worker.cc:865-887): captures per-kernel device timelines
    (``<logdir>/plugins/profile/<run>/*.xplane.pb``) instead of host-side
    gettimeofday deltas.

    with XlaTrace("/tmp/xprof"): run_jitted_things()

    A profiler that cannot start or stop raises: a missing trace is an
    error, not an empty measurement.
    """

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.active = False

    def __enter__(self):
        import jax

        jax.profiler.start_trace(self.logdir)
        self.active = True
        return self

    def __exit__(self, *exc):
        import jax

        self.active = False
        jax.profiler.stop_trace()
        return False


def annotate(name: str):
    """Named host span visible in XLA profiler timelines
    (jax.profiler.TraceAnnotation)."""
    import jax

    return jax.profiler.TraceAnnotation(name)
