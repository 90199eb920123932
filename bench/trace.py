"""The device trace of a traced run: kernel and copy records from the
PyTorch profiler (Kineto over CUPTI), read as raw records.

:class:`DeviceTrace` starts the profiler's Kineto backend directly and
reads its result's records without building PyTorch's event tree, which
for a whole outer iteration (~10^6 kernel records) would cost minutes.
The harness brackets the traced call with a ``record_function`` span,
which gives the traced window on the records' own clock.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "bench.traced"


def _config():
    from torch._C._profiler import (ProfilerConfig, ProfilerState,
                                    _ExperimentalConfig)
    args = (ProfilerState.KINETO, False, False, False, False, False,
            _ExperimentalConfig())
    try:
        return ProfilerConfig(*args)
    except TypeError:
        return ProfilerConfig(*args, "")


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


class DeviceTrace:
    """``with DeviceTrace(device) as tr: fn()`` records the CUDA kernels,
    copies and host ops that ``fn`` runs (on a CPU device: host ops only).
    After the block: ``tr.device`` holds ``(name, start_ns, end_ns)`` of
    every device record, ``tr.host`` the host ops', ``tr.window`` the
    bracketing span's ``(start_ns, end_ns)``."""

    def __init__(self, device: torch.device):
        from torch._C._profiler import ProfilerActivity
        self.device = torch.device(device)
        self.activities = {ProfilerActivity.CPU}
        if self.device.type == "cuda":
            self.activities.add(ProfilerActivity.CUDA)
        self.device_events: List[Tuple[str, int, int]] = []
        self.host: List[Tuple[str, int, int]] = []
        self.window: Optional[Tuple[int, int]] = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.autograd import _enable_profiler, _prepare_profiler
        self._sync()
        cfg = _config()
        _prepare_profiler(cfg, self.activities)
        _enable_profiler(cfg, self.activities)
        self._span = torch.autograd.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler
        self._sync()
        self._span.__exit__(None, None, None)
        result = _disable_profiler()
        cuda = torch.autograd.DeviceType.CUDA
        for e in result.events():
            start = _ns(e, "start")
            rec = (e.name(), start, start + _ns(e, "duration"))
            if rec[0] == WINDOW_SPAN:
                # The span's own record, and its copy on the device's
                # timeline (a user annotation, not work).
                if e.device_type() != cuda:
                    self.window = rec[1:]
            elif e.device_type() == cuda:
                self.device_events.append(rec)
            else:
                self.host.append(rec)
        return False

    def kernels(self) -> List[Tuple[str, int, int]]:
        """The kernel records: device records other than copies and sets."""
        return [e for e in self.device_events
                if not e[0].startswith(("Memcpy", "Memset"))]


def by_name(records) -> Dict[str, float]:
    """Device seconds per record name."""
    out: Dict[str, float] = {}
    for name, s, e in records:
        out[name] = out.get(name, 0.0) + (e - s) * 1e-9
    return out
