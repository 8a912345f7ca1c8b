"""Iterator state ↔ checkpoint manifest glue (a copy of
:mod:`tony_tpu.data.ckptio` over the port's format).

The pipeline cursor is a small JSON dict; it rides the SAME committed step
as the train state by being encoded into a uint8 leaf of the saved pytree::

    {"model": <TrainState>, "data_iter": <uint8 json blob>}

so one atomic directory rename commits model and stream position together —
there is no window where the model resumed at step N but the data stream at
step N−1. The blob is written by process 0 only (the snapshot engine's
ownership rule) and is byte-identical across processes anyway: the cursor
is GLOBAL by construction (:mod:`tony_tpu_torch.data.pipeline`).

Reading back is manifest-direct (:func:`load_iter_state`): the blob's
length is only known from the manifest, so it cannot be expressed as a
``restore_pytree`` target leaf — and staying on the
:mod:`~tony_tpu_torch.ckpt.format` path means a checkpoint's stream
position is read without restoring anything.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np

from tony_tpu_torch.ckpt import format as fmt

# Leaf names inside the wrapped save tree, and the keystr path the cursor
# gets (the manifest's join key).
MODEL_KEY = "model"
DATA_ITER_KEY = "data_iter"
DATA_ITER_PATH = f"['{DATA_ITER_KEY}']"


def encode_state(state: Mapping[str, Any]) -> np.ndarray:
    """Iterator-state dict → uint8 leaf (UTF-8 JSON, sorted keys)."""
    return np.frombuffer(
        json.dumps(dict(state), sort_keys=True).encode("utf-8"),
        dtype=np.uint8).copy()


def decode_state(blob: np.ndarray) -> Dict[str, Any]:
    return json.loads(np.asarray(blob, dtype=np.uint8).tobytes()
                      .decode("utf-8"))


def wrap_for_save(train_state: Any,
                  iter_state: Mapping[str, Any]) -> Dict[str, Any]:
    """The pytree ``train_loop`` hands the checkpointer when a data
    iterator is attached."""
    return {MODEL_KEY: train_state, DATA_ITER_KEY: encode_state(iter_state)}


def has_iter_state(root: Union[str, Path], step: int) -> bool:
    """Does the committed step carry a data-plane cursor (i.e. was it
    written by a wrapped save)? Distinguishes bare-state checkpoints,
    which restore fine but carry no stream position."""
    manifest = fmt.read_manifest(root, step)
    return any(m["path"] == DATA_ITER_PATH for m in manifest["leaves"])


def load_iter_state(root: Union[str, Path],
                    step: Optional[int] = None) -> Dict[str, Any]:
    """Read the iterator state out of a committed checkpoint (newest step
    by default): manifest + seek-read of the one uint8 leaf."""
    if step is None:
        step = fmt.latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    manifest = fmt.read_manifest(root, step)
    idx = next((i for i, m in enumerate(manifest["leaves"])
                if m["path"] == DATA_ITER_PATH), None)
    if idx is None:
        raise KeyError(
            f"checkpoint step {step} under {root} carries no "
            f"{DATA_ITER_PATH} leaf — saved without a data iterator "
            f"attached")
    meta = manifest["leaves"][idx]
    out = np.empty(tuple(meta["shape"]), dtype=np.uint8)
    filled = 0
    with fmt.ChunkReader(root, step, manifest) as reader:
        for chunk in reader.chunks_for_leaf(idx):
            start = int(chunk["start"][0])
            data = reader.read(chunk, np.uint8)
            out[start:start + data.shape[0]] = data
            filled += data.shape[0]
    if filled != out.shape[0]:
        raise IOError(
            f"checkpoint step {step}: {DATA_ITER_PATH} chunks cover "
            f"{filled} of {out.shape[0]} bytes — incomplete payload")
    return decode_state(out)
