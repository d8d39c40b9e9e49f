"""Step timing and XLA profiler hooks.

The reference ships no tracing or profiling at all — its only
instrumentation is rich progress bars driven by per-stage callbacks
(``/root/reference/gecco/cli/_log.py:96-108``; SURVEY §5.1).  This
build adds two first-class observability primitives:

* :class:`StageTimer` — wall-clock accounting of every pipeline stage,
  reported by the CLI at ``-vv``;
* :func:`xla_trace` — wraps a command in a ``jax.profiler`` trace
  (``--profile DIR``) producing a TensorBoard/Perfetto-compatible
  XPlane dump of every XLA/Pallas kernel launched on the device.

Both keep the reference's callback-style progress contract intact: the
timer is orthogonal to the per-stage ``progress`` callbacks threaded
through the layers (as in ``gecco/orf.py:93``,
``gecco/hmmer/__init__.py:101``).
"""

import contextlib
import functools
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

__all__ = ["StageTimer", "TIMER", "timed", "xla_trace"]


class StageTimer:
    """Accumulates named wall-clock stage durations in call order."""

    def __init__(self) -> None:
        self.records: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((name, time.perf_counter() - start))

    def summary(self) -> Dict[str, Tuple[int, float]]:
        """Aggregate ``{stage: (calls, total_seconds)}`` preserving order."""
        out: Dict[str, Tuple[int, float]] = {}
        for name, seconds in self.records:
            calls, total = out.get(name, (0, 0.0))
            out[name] = (calls + 1, total + seconds)
        return out

    def reset(self) -> None:
        self.records.clear()


#: Process-wide timer used by the CLI pipeline stages.
TIMER = StageTimer()


def timed(name: str) -> Callable:
    """Decorator recording the wall time of every call under ``name``."""

    def decorate(function: Callable) -> Callable:
        @functools.wraps(function)
        def wrapper(*args, **kwargs):
            with TIMER.stage(name):
                return function(*args, **kwargs)

        return wrapper

    return decorate


@contextlib.contextmanager
def xla_trace(logdir: Optional[str]) -> Iterator[None]:
    """Trace all device activity into ``logdir`` (no-op when ``None``)."""
    if not logdir:
        yield
        return
    import jax

    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()
