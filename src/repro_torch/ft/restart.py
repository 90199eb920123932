"""Restart manager: crash-consistent resume of the trainer, PyTorch port
of ``repro/ft/restart.py``.

Composes the checkpoint manager with the data pipeline's O(1) stream state
so a restart is exact: (params, optimizer state, step) from the
checkpoint, and the next batch is ``batch(step)`` by construction.
:meth:`RestartManager.resume_or_init` is the one entry point the trainer
uses: on a fresh start it initializes, after a crash it restores, and
with a mesh it places the restored tensors through
:func:`repro_torch.checkpoint.restore_resharded`.  The files are the
reference's, so either package resumes the other's run.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from ..checkpoint.manager import CheckpointManager, restore_resharded


class RestartManager:
    def __init__(self, ckpt_dir: str, save_every: int = 100, keep: int = 3):
        self.mgr = CheckpointManager(ckpt_dir, keep=keep)
        self.save_every = save_every

    def resume_or_init(self, init_fn: Callable[[], Any], mesh=None):
        """Returns ``(state_tree, start_step)``.  After a crash the state
        of ``init_fn()`` is the template: the restored tree takes its
        structure, types, dtypes and devices (a torch tree has no
        allocation-free stand-in for ``jax.eval_shape``)."""
        step = self.mgr.latest_step()
        if step is None:
            return init_fn(), 0
        template = init_fn()
        if mesh is not None:
            tree, manifest = restore_resharded(self.mgr, template, mesh)
        else:
            tree, manifest = self.mgr.restore(template)
        return tree, int(manifest["step"])

    def maybe_save(self, step: int, tree: Any,
                   extra: Optional[dict] = None) -> bool:
        if step % self.save_every == 0 and step > 0:
            self.mgr.save(step, tree, extra)
            return True
        return False
