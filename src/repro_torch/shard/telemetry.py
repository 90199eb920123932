"""Collective accounting of the shard engine (PyTorch port of
``repro/shard/telemetry.py``).

The engine's contract is stated in collective counts: one all-reduce per
approximate pass and one setup reduction per multi-pass program.  The
reference counts ``psum`` sites as its program is traced, once per
compilation; here the program runs eagerly, so the engine marks each of
its sections (the setup, each pass) with :meth:`CollectiveTrace.section`
and routes every collective through :meth:`CollectiveTrace.all_reduce`:
the first run of a section records its collectives and their payload
bytes, and every later run of the same section must issue the same ones,
or the trace raises.  The counts are therefore per execution of a
section, as the reference's are; runtime totals are ``setup + passes_run
* per_pass``, charged to the :class:`~repro_torch.core.selection
.SyncLedger` after the read.  The payload bytes are the tensors' sizes
(the reference's traced avals), so the counts and bytes equal the
reference's for the same shapes.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional


class CollectiveTrace:
    """Counts the engine's all-reduce sites, grouped by (program, tag)."""

    def __init__(self) -> None:
        self.sites: Dict[str, Dict[str, int]] = {}
        self.site_bytes: Dict[str, Dict[str, int]] = {}
        self._active: Dict[str, int] = {}
        self._active_bytes: Dict[str, int] = {}
        self._program: Optional[str] = None
        self._section: Optional[str] = None
        self._run = [0, 0]     # this section run's (sites, bytes)

    def begin(self, program: str) -> None:
        """Start recording ``program`` (its earlier record is replaced)."""
        self._active = {}
        self._active_bytes = {}
        self._program = program

    def _require_active(self, op: str) -> None:
        if self._program is None:
            raise RuntimeError(
                f"CollectiveTrace.{op}() called outside a begin()/commit() "
                "window: call begin(<program>) at the top of the program "
                "body before routing collectives through the trace.")

    @contextmanager
    def section(self, tag: str):
        """One run of the program section ``tag`` (the setup, a pass)."""
        self._require_active("section")
        self._section, self._run = tag, [0, 0]
        try:
            yield
        finally:
            self._section = None
        sites, nbytes = self._run
        if tag not in self._active:
            self._active[tag], self._active_bytes[tag] = sites, nbytes
        elif (self._active[tag], self._active_bytes[tag]) != (sites, nbytes):
            raise RuntimeError(
                f"section {tag!r} of {self._program!r} issued {sites} "
                f"collectives ({nbytes} bytes), an earlier run "
                f"{self._active[tag]} ({self._active_bytes[tag]} bytes)")

    def all_reduce(self, x, mesh, *, tag: str):
        """``mesh.all_reduce(x)`` (a sum, in place), counted as a site of
        section ``tag``, with its payload bytes."""
        self._require_active("all_reduce")
        if self._section != tag:
            raise RuntimeError(f"all_reduce tagged {tag!r} outside its "
                               f"section (open: {self._section!r})")
        self._run[0] += 1
        self._run[1] += x.numel() * x.element_size()
        return mesh.all_reduce(x)

    def commit(self) -> None:
        """Finish the record started by :meth:`begin`."""
        self._require_active("commit")
        self.sites[self._program] = dict(self._active)
        self.site_bytes[self._program] = dict(self._active_bytes)
        self._program = None

    def count(self, program: str, tag: str) -> int:
        return self.sites.get(program, {}).get(tag, 0)

    def bytes_of(self, program: str, tag: str) -> int:
        """Per-execution payload bytes of ``program``'s ``tag`` sites."""
        return self.site_bytes.get(program, {}).get(tag, 0)
