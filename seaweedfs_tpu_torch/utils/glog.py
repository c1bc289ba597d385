"""Leveled logging in the shape of upstream's glog: `V(n)` verbosity
gating on top of stdlib logging, so call sites read `glog.V(3).infof(...)`.
Verbosity comes from set_verbosity() or the WEEDTPU_V knob.

Every line takes a ` trace=<id>` suffix when the calling thread has a
current trace id (`obs.trace`: a root from `start`, an RPC's continued
id, or `collect`). `kv(...)` formats extra context pairs in the same
grep-stable shape."""

from __future__ import annotations

import logging
import sys

from seaweedfs_tpu_torch.utils import config

_logger = logging.getLogger("seaweedfs_tpu_torch")
if not _logger.handlers:
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(
        logging.Formatter("%(levelname).1s%(asctime)s %(name)s] %(message)s", "%m%d %H:%M:%S")
    )
    _logger.addHandler(h)
    _logger.setLevel(logging.INFO)
    _logger.propagate = False

_verbosity = config.env("WEEDTPU_V")


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = v


def kv(**pairs) -> str:
    """key=value context in the grep-stable shape log lines use:
    glog.info("repair done %s", glog.kv(vid=3))."""
    return " ".join(f"{k}={v}" for k, v in pairs.items())


def _ctx_suffix() -> str:
    """` trace=<id>` when this thread has a current trace id. Lazy import:
    glog is a leaf module and obs.trace must import from anywhere."""
    try:
        from seaweedfs_tpu_torch.obs import trace as _trace

        tid = _trace.current_trace_id()
    except Exception:  # noqa: BLE001 — logging must never raise
        return ""
    return f" trace={tid}" if tid else ""


def _with_ctx(msg):
    """Suffix the trace context onto string messages; other messages (an
    exception handed straight to the logger) pass through untouched."""
    if not isinstance(msg, str):
        return msg
    return msg + _ctx_suffix()


class _Verbose:
    def __init__(self, enabled: bool):
        self.enabled = enabled

    def info(self, msg: str, *args) -> None:
        if self.enabled:
            _logger.info(_with_ctx(msg), *args)

    infof = info


def V(level: int) -> _Verbose:  # noqa: N802 — glog's API shape
    return _Verbose(level <= _verbosity)


def info(msg: str, *args) -> None:
    _logger.info(_with_ctx(msg), *args)


def warning(msg: str, *args) -> None:
    _logger.warning(_with_ctx(msg), *args)


def error(msg: str, *args) -> None:
    _logger.error(_with_ctx(msg), *args)


infof = info
warningf = warning
errorf = error
