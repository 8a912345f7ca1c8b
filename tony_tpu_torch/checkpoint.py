"""Checkpoint/resume helper — the thin shim over
:mod:`tony_tpu_torch.ckpt` that :mod:`tony_tpu.checkpoint` is over the JAX
package's plane: ``save`` / ``restore_or`` / ``latest_step`` / ``close``
for user scripts that resume across gang restarts
(``tony.am.retry-count``). A port train state goes through its portable
form (:func:`tony_tpu_torch.ckpt.encode_portable`) both ways.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

from tony_tpu_torch import ckpt as _ckpt


class Checkpointer:
    """Directory-bound save/restore manager (seed-compatible surface)."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self._mgr = _ckpt.AsyncCheckpointer(self.directory, keep=max_to_keep)

    def save(self, state: Any, step: Optional[int] = None,
             wait: bool = True) -> None:
        """Save a tree (e.g. a TrainState); all processes must call.
        ``wait=False`` returns after the staging copy and commits in the
        background (:class:`tony_tpu_torch.ckpt.AsyncCheckpointer`)."""
        self._mgr.save(_ckpt.encode_portable(state), step=step, block=wait)

    def latest_step(self) -> Optional[int]:
        return _ckpt.latest_step(self.directory)

    def restore_or(self, state: Any, mesh: Any = None) -> Any:
        """Restore the latest checkpoint into ``state`` (in place for its
        tensors), or return ``state`` unchanged when none exists (first
        attempt)."""
        # Drain in-flight async saves first: "latest" must mean latest.
        self._mgr.wait()
        return _ckpt.decode_portable(_ckpt.restore_latest(
            self.directory, _ckpt.encode_portable(state), mesh=mesh), mesh)

    def wait_until_finished(self) -> None:
        self._mgr.wait()

    def close(self) -> None:
        self._mgr.close()
