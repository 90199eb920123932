"""Block steps that run once per block: a plain loop on the CPU, replays of
one captured CUDA graph on the card.

An exact block step (the spec's oracle, the line search, the cache insert
with its LRU slot and Gram row, the averaging step) is about a hundred
small device ops, and so is a fold-in step.  Launched one by one from
Python they cost ~1.2 ms of host time for ~0.16 ms of device work (ROADMAP
C2).  The reference runs these loops as one ``lax.scan``; here the step
body is written once, with the block read by index on the device
(:class:`StepControl`), and

  * on a CPU state the body runs in a plain loop: the plain version;
  * on a CUDA state the first step runs eagerly (every kernel is built and
    loaded), the body is captured once into a CUDA graph, and every later
    block is one ``replay()``.

A captured graph bakes in the data pointers of the tensors the body
touches.  :class:`StepGraphs` keeps an engine's graphs keyed by those
tensors (weak references and data pointers) and captures anew when one of
them is replaced: a restored checkpoint, a new state, another cache
layout.  A graph whose tensors died is dropped, never replayed.  There is
no fallback: a capture that fails raises.

Capture runs on a side stream that waits for the engine's stream (the
legacy default stream cannot be captured); replays run on the engine's
current stream, in order with the rest of its work.  The kernel wrappers'
launch counters tick while the body is captured, not when the graph runs:
the capture's counts are taken back and the body's launches are added on
every replay (:func:`repro_torch.kernels.ops.add_launches`).
"""
from __future__ import annotations

import gc
import weakref
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..kernels import ops as kops
from .averaging import weight_table
from .types import upload


class StepControl(NamedTuple):
    """The per-pass inputs of a block step, read on the device by ``cursor``.

    Attributes:
      ids:       (m,) int64 block ids of the pass, in order.
      weights:   (m, 2) float32 averaging weights of the pass's steps.
      cursor:    (1,) int64 position in the pass; the step advances it.
      it:        (1,) int32 outer iteration (activity stamps).
      scratch:   (d+1,) float32 scratch of the averaging step.
      planes:    (m, d+1) float32 candidate planes (the fold), or None.
      fb_planes: (m, d+1) float32 fallback planes (the fold), or None.
      fb_slots:  (m,) int64 fallback slots (the fold), or None.
    """

    ids: torch.Tensor
    weights: torch.Tensor
    cursor: torch.Tensor
    it: torch.Tensor
    scratch: torch.Tensor
    planes: Optional[torch.Tensor] = None
    fb_planes: Optional[torch.Tensor] = None
    fb_slots: Optional[torch.Tensor] = None

    def block(self) -> torch.Tensor:
        """The step's block id, (1,) int64."""
        return self.ids.index_select(0, self.cursor)

    def weight(self) -> torch.Tensor:
        """The step's averaging weights ``(a, b)``, (2,) float32."""
        return self.weights.index_select(0, self.cursor)[0]


def new_control(m: int, d: int, device, *, fold: bool = False
                ) -> StepControl:
    """Buffers for passes of up to ``m`` blocks of ``(d+1)``-planes."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return StepControl(
        ids=z(m, dtype=torch.int64), weights=z(m, 2),
        cursor=z(1, dtype=torch.int64), it=z(1, dtype=torch.int32),
        scratch=z(d + 1),
        planes=z(m, d + 1) if fold else None,
        fb_planes=z(m, d + 1) if fold else None,
        fb_slots=z(m, dtype=torch.int64) if fold else None)


def load_control(ctl: StepControl, ids, *, k0: int, it: int,
                 planes: Optional[torch.Tensor] = None,
                 fb_planes: Optional[torch.Tensor] = None,
                 fb_slots: Optional[torch.Tensor] = None) -> None:
    """Set up a pass over the blocks ``ids`` (a host array, or an int64
    tensor on the control's device, taken by one device-to-device copy):
    averaging weights for ``k = k0, k0+1, ...``
    (:func:`repro_torch.core.averaging.weight_table`), the stamp ``it``,
    the cursor at 0 and, for the fold, its candidates.  Enqueued on the
    current stream; nothing waits for the device."""
    m = len(ids)
    if isinstance(ids, torch.Tensor):
        ctl.ids[:m].copy_(ids)
    else:
        upload(np.asarray(ids, np.int64), out=ctl.ids)
    upload(weight_table(k0, m), out=ctl.weights)
    ctl.it.fill_(int(it))
    ctl.cursor.zero_()
    for dst, src in ((ctl.planes, planes), (ctl.fb_planes, fb_planes),
                     (ctl.fb_slots, fb_slots)):
        if src is not None:
            dst[:m].copy_(src[:m])


class _Graph:
    """One body captured on a side stream, and the kernel launches it
    makes on every replay."""

    def __init__(self, body: Callable[[], None], device: torch.device):
        self.graph = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        before = kops.launch_counts()
        # No cyclic garbage collection inside the capture: one could free
        # an unreachable graph of an earlier engine, and CUDA refuses to
        # destroy a graph while this thread captures (the capture is then
        # invalidated).
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                # thread_local: another host thread may use the card
                # meanwhile.
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    body()
                except BaseException:
                    try:
                        self.graph.capture_end()
                    except RuntimeError:
                        pass         # the body's error is the one to see
                    raise
                self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        main.wait_stream(side)
        after = kops.launch_counts()
        kops.set_launch_counts(before)
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}

    def replay(self) -> None:
        self.graph.replay()
        kops.add_launches(self.launches)


def _alive(refs, tensors: Sequence[torch.Tensor]) -> bool:
    return len(refs) == len(tensors) and all(
        r() is t and p == t.data_ptr() for (r, p), t in zip(refs, tensors))


class _Entry:
    """The control buffers of one kind of step, its captured bodies, and
    the tensors they were captured on."""

    def __init__(self, tensors, consts, ctl: StepControl):
        self.refs = [(weakref.ref(t), t.data_ptr()) for t in tensors]
        self.consts = consts
        self.ctl = ctl
        self.graphs: Dict[str, _Graph] = {}

    def matches(self, tensors, consts, m: int) -> bool:
        return (self.consts == consts and m <= self.ctl.ids.shape[0]
                and _alive(self.refs, tensors))


class StepGraphs:
    """An engine's block steps: the CPU's plain loop, or the card's
    captured graphs, kept from one pass to the next.

    ``replays`` counts graph replays since construction (the profile
    reads it per block).
    """

    def __init__(self):
        self._entries: Dict[str, _Entry] = {}
        self.replays = 0

    def control(self, kind: str, tensors: Sequence[torch.Tensor],
                consts: tuple, m: int, d: int, *, fold: bool = False
                ) -> StepControl:
        """The control buffers of step ``kind`` for a pass of ``m``
        blocks.  ``tensors`` are every tensor the step's bodies read or
        write, ``consts`` every host value they bake in (``lam``, the
        oracle); when either changed since the capture, the old graphs are
        dropped and new buffers made."""
        tensors = tuple(tensors)
        entry = self._entries.get(kind)
        if entry is None or not entry.matches(tensors, consts, m):
            entry = _Entry(tensors, consts, new_control(
                m, d, tensors[0].device, fold=fold))
            self._entries[kind] = entry
        return entry.ctl

    def run(self, kind: str, body_name: str, body: Callable[[], None],
            times: int) -> None:
        """Run ``body`` ``times`` times on the tensors of :meth:`control`'s
        last call for ``kind``: in a loop on the CPU; on CUDA as replays
        of its captured graph, captured after one eager step the first
        time it runs."""
        if times <= 0:
            return
        entry = self._entries[kind]
        device = entry.ctl.cursor.device
        if device.type != "cuda":
            for _ in range(times):
                body()
            return
        graph = entry.graphs.get(body_name)
        if graph is None:
            body()                       # warm-up: every kernel built
            times -= 1
            graph = entry.graphs[body_name] = _Graph(body, device)
        for _ in range(times):
            graph.replay()
        self.replays += times
