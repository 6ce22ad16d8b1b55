"""Tracing / profiling / logging utilities.

The replacement for the reference's observability stack
(ref: TD_TIMER_START/TD_TIMER_GET_FMT scoped timers used at every stage,
e.g. frame_main/libs/MVS/SceneDensify.cpp:760,3008,3267; Util::Progress
bars; Util::LogMemoryInfo at shutdown, DensifyPointCloud.cpp:362; and the
listener-based Log multiplexer in frame_main/libs/Common/Log.h):

- ``stage_timer``: scoped wall-clock timer that accumulates into a global
  per-stage report (the TD_TIMER analog).
- ``report()`` / ``log_report()``: per-stage totals, call counts, and
  device-memory stats — printed at pipeline end like the reference's
  shutdown summary.
- ``trace()``: wraps a block in a ``jax.profiler`` trace so TensorBoard /
  Perfetto captures device timelines (the sampling profiler the reference
  never had).
- ``get_logger``: one shared logging config (console, optional file) with
  verbosity levels mirroring g_nVerbosityLevel.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Optional

_STAGES: Dict[str, Dict[str, float]] = defaultdict(
    lambda: {"total_s": 0.0, "calls": 0, "max_s": 0.0})

_LOGGER: Optional[logging.Logger] = None


def get_logger(logfile: Optional[str] = None,
               verbosity: int = 2) -> logging.Logger:
    """Shared logger; ``verbosity`` 0..4 maps to ERROR..DEBUG
    (ref: g_nVerbosityLevel)."""
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("hcmvs_tpu")
        logger.propagate = False
        fmt = logging.Formatter("%(asctime)s [%(levelname).1s] %(message)s",
                                datefmt="%H:%M:%S")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if logfile:
            fh = logging.FileHandler(logfile)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        levels = [logging.ERROR, logging.WARNING, logging.INFO,
                  logging.DEBUG, logging.DEBUG]
        logger.setLevel(levels[min(max(verbosity, 0), 4)])
        _LOGGER = logger
    return _LOGGER


@contextlib.contextmanager
def stage_timer(name: str, block_on=None, log: bool = False):
    """Scoped timer accumulating into the stage report.

    ``block_on``: optional array/pytree passed to jax.block_until_ready so
    the measured span covers device work dispatched inside the block.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if block_on is not None:
            import jax
            jax.block_until_ready(block_on() if callable(block_on)
                                  else block_on)
        dt = time.perf_counter() - t0
        s = _STAGES[name]
        s["total_s"] += dt
        s["calls"] += 1
        s["max_s"] = max(s["max_s"], dt)
        if log:
            get_logger().info("%s: %.3fs", name, dt)


def reset_report() -> None:
    _STAGES.clear()


def report() -> Dict[str, Dict[str, float]]:
    """Snapshot of accumulated stage timings."""
    return {k: dict(v) for k, v in _STAGES.items()}


def device_memory_stats() -> Dict[str, int]:
    """Live device-memory stats where the backend exposes them
    (the Util::LogMemoryInfo analog)."""
    try:
        import jax
        dev = jax.devices()[0]
        stats = dev.memory_stats() or {}
        return {k: int(v) for k, v in stats.items()
                if "bytes" in k and isinstance(v, (int, float))}
    except Exception:
        return {}


def log_report(logger: Optional[logging.Logger] = None) -> str:
    """Format + log the per-stage report (pipeline shutdown summary)."""
    logger = logger or get_logger()
    lines = ["stage timing report:"]
    for name, s in sorted(_STAGES.items(), key=lambda kv: -kv[1]["total_s"]):
        lines.append(f"  {name:<32} {s['total_s']:9.3f}s "
                     f"x{int(s['calls']):<4} max {s['max_s']:.3f}s")
    mem = device_memory_stats()
    if mem:
        used = mem.get("bytes_in_use", 0)
        peak = mem.get("peak_bytes_in_use", 0)
        lines.append(f"  device memory: in_use={used / 1e6:.1f}MB "
                     f"peak={peak / 1e6:.1f}MB")
    msg = "\n".join(lines)
    logger.info(msg)
    return msg


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """jax.profiler trace around a block (view in TensorBoard/Perfetto);
    a fresh temporary directory unless ``log_dir`` is given."""
    import tempfile
    import jax
    log_dir = log_dir or tempfile.mkdtemp(prefix="hcmvs_trace_")
    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
