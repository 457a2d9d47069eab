"""What every task trainer shares (the port's counterpart of the JAX
package's ``utils/trainer.py``), for one process: checkpointing of the
trainer's whole state, and the data-parallel hooks, which pass their
input through.

Inside a task trainer:

    self.core = TrainerCore(use_mesh=use_mesh, device=self.device)
    ...
    trainer.save(directory, epoch)          # Checkpointing
    start = trainer.restore(directory)      # the restored step, or None
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

import torch

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint


def load_generator_state(generator: torch.Generator,
                         state: torch.Tensor) -> None:
    """Set ``generator`` to a saved ``get_state()``, which a checkpoint
    may have moved to the card (a generator state is a CPU byte tensor).
    A state saved from another device's kind of generator (a card's
    Philox state against the CPU's Mersenne Twister) cannot continue its
    stream there: the generator then keeps its own, with a warning, so a
    card's checkpoint still restores into a trainer on the CPU."""
    state = state.cpu()
    if state.numel() != generator.get_state().numel():
        warnings.warn(f"a {state.numel()}-byte generator state cannot "
                      f"continue on a {generator.device.type} generator; "
                      f"it keeps its own stream", stacklevel=2)
        return
    generator.set_state(state)


class TrainerCore:
    """Checkpoint plumbing and the data-parallel hooks of one process.

    The JAX core runs a trainer SPMD over a ``data`` mesh with
    ``use_mesh`` (or an explicit ``mesh``); the port's counterpart over
    ``torch.distributed`` is not written yet, so either raises a
    ``ValueError``. ``device`` is where ``restore`` puts the tensors it
    loads."""

    def __init__(self, use_mesh: bool = False, mesh=None, device=None):
        if use_mesh or mesh is not None:
            raise ValueError("data-parallel training over a mesh "
                             "(use_mesh / mesh) is not ported yet "
                             "(ROADMAP queue 1 item 10)")
        self.mesh = None
        self.device = device

    def prepare(self, tree):
        """Replicate a parameter or optimizer state (one process: as
        given)."""
        return tree

    def shard(self, batch):
        """Split a batch over the data-parallel ranks (one process: as
        given)."""
        return batch

    @property
    def data_parallel_size(self) -> int:
        return 1

    def save(self, directory: str, step: int, state: Dict[str, Any]) -> None:
        """Checkpoint a trainer's state dict as ``step``."""
        save_checkpoint(directory, step, state)

    def restore(self, directory: str, step: Optional[int] = None
                ) -> Optional[Dict[str, Any]]:
        """The state dict saved as ``step`` (the newest when None) with its
        tensors on the trainer's device, or None without a checkpoint."""
        return restore_checkpoint(directory, step, map_location=self.device)

    def latest_step(self, directory: str) -> Optional[int]:
        return latest_step(directory)


class Checkpointing:
    """``save`` and ``restore`` of a trainer with a ``core``
    (``TrainerCore``) and ``state_dict`` / ``load_state_dict``."""

    core: TrainerCore

    def save(self, directory: str, step: int) -> None:
        """Checkpoint the trainer's whole state as ``step``."""
        self.core.save(directory, step, self.state_dict())

    def restore(self, directory: str, step: Optional[int] = None
                ) -> Optional[int]:
        """Load the state saved as ``step`` (the newest when None); returns
        the step, or None when ``directory`` holds none. The modules exist
        from the constructor on, so no sample input is needed."""
        if step is None:
            step = self.core.latest_step(directory)
        if step is None:
            return None
        self.load_state_dict(self.core.restore(directory, step))
        return step
