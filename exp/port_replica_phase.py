"""The ``serve_replica`` phase of ``chip_smoke.py`` at full depth, on one
card.

``chip_smoke.py`` serves the 8-layer step its ``train_ckpt`` phase
commits: the machine ends a command after 45 GiB of disk writes, and
that phase already writes 30.6 GB. This command writes one seeded
llama2-7b params-only step of its own instead (f32 masters, as a train
job commits them; 32 layers = 27.0 GB, ``--layers`` cuts the depth),
then runs the same phase on it: ``published.json`` on the step, a
``Replica`` restoring it with the bf16 policy (``xent_chunk=1024``, so
the head is read from ``lm_head_kernel``), every served parameter
checked bitwise against the f32 leaves, the 16-request mix over the RPC
wire and in-process, the stats file, a hot swap onto a republication
under load and a refused swap. It prints the restore seconds and GB/s,
the time from ``Replica(...)`` to the first token, the decode numbers
and the swap's, then deletes the step. Builds only the flash-decode
kernel. Run from the repository root on a machine with one GPU::

    python3 exp/port_replica_phase.py [--layers 32] > out.json

stderr has the phase log; stdout ends with the ``{"serve_replica":
...}`` line (with the save's seconds) and the card's ``nvidia-smi`` name
and power limit.
"""

import argparse
import gc
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tony_tpu_torch import ckpt  # noqa: E402
from tony_tpu_torch.models import get_model  # noqa: E402
from tony_tpu_torch.models.convert import jax_param_tree  # noqa: E402
from tony_tpu_torch.ops import _build  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "replica_phase")
STEP = 4


def save_step(layers):
    """A seeded llama2-7b params-only step in f32 (the train_loop cell's
    config at ``layers``), written through the async checkpointer.
    Returns its bytes and the save's seconds."""
    model = get_model("llama2-7b", device="cuda", seed=cs.SEED,
                      n_layers=layers, xent_chunk=cs.LOOP_XENT_CHUNK)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    free = shutil.disk_usage(ROOT).free
    if free < 2 * nbytes or nbytes > cs.CKPT_WRITE_LIMIT:
        raise RuntimeError(f"{nbytes / 1e9:.2f} GB step: {free / 1e9:.1f} "
                           f"GB free, {cs.CKPT_WRITE_LIMIT >> 30} GiB "
                           f"write limit")
    t0 = time.monotonic()
    saver = ckpt.AsyncCheckpointer(ROOT)
    saver.save(jax_param_tree(model), step=STEP, block=True)
    saver.close()
    seconds = time.monotonic() - t0
    cs.log(f"  saved {nbytes / 1e9:.2f} GB ({layers} layers, f32) in "
           f"{seconds:.1f} s")
    del model, saver
    gc.collect()
    torch.cuda.empty_cache()
    return nbytes, seconds


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--layers", type=int, default=32)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"[device] {card}")
    t0 = time.monotonic()
    _build.load(("flash_decode",))
    cs.log(f"[build] {time.monotonic() - t0:.1f} s")
    shutil.rmtree(ROOT, ignore_errors=True)
    os.makedirs(ROOT)
    try:
        cs.log("[save]")
        nbytes, save_s = save_step(args.layers)
        cs.log("[serve_replica]")
        t0 = time.monotonic()
        res = cs.serve_replica_phase(card, ROOT, args.layers, STEP)
        cs.log(f"  phase {time.monotonic() - t0:.1f} s")
    finally:
        shutil.rmtree(ROOT, ignore_errors=True)
    res.update(saved_bytes=nbytes, save_s=save_s)
    print(json.dumps({"serve_replica": res}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
