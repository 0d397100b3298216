"""Profiling hooks: XLA/xprof tracing around the device hot paths.

The reference's only profiling signals are work histograms and a per-search
stopwatch (SURVEY.md §5); on the GPU the right tool is the XLA profiler.  The
server exposes it two ways:

  * `--profile-port N` starts the jax.profiler gRPC server so
    xprof/TensorBoard can capture live traces of serving traffic;
  * `trace(name)` annotates host spans (search dispatch, merges,
    checkpoints) so device timelines line up with engine phases.
"""

from __future__ import annotations

import contextlib
import logging

log = logging.getLogger("acoustid_index.profiling")


def start_profiler_server(port: int) -> None:
    import jax

    jax.profiler.start_server(port)
    log.info("XLA profiler server on port %d", port)


@contextlib.contextmanager
def trace(name: str):
    """Annotate a host-side span in the device trace timeline."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def capture(log_dir: str):
    """Capture a programmatic trace into `log_dir` (for offline analysis)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
