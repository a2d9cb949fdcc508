"""Profiling / micro-benchmark helpers.

The reference has no in-library tracing (SURVEY.md §5); the
equivalents are thin wrappers over ``jax.profiler`` plus a
``block_until_ready`` micro-bench harness used by ``bench.py`` and perf
tests.
"""

import contextlib
import time

import jax

__all__ = ['Timer', 'benchmark', 'trace']


class Timer:
    """Wall-clock timer context that blocks on device work.

    Example::

        with Timer('render') as t:
            out = render(params)
            t.block(out)
        print(t.elapsed)
    """

    def __init__(self, name=''):
        self.name = name
        self.elapsed = None
        self._out = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def block(self, out):
        self._out = out
        return out

    def __exit__(self, *exc):
        if self._out is not None:
            jax.block_until_ready(self._out)
        self.elapsed = time.perf_counter() - self._t0
        return False


def benchmark(fn, *args, iters=10, warmup=2, **kwargs):
    """Time ``fn(*args, **kwargs)`` with device sync.

    Returns:
        dict with mean / min seconds per iteration and the last output.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return {'mean_s': sum(times) / len(times), 'min_s': min(times),
            'iters': iters, 'out': out}


@contextlib.contextmanager
def trace(log_dir):
    """jax.profiler trace context (view with tensorboard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
