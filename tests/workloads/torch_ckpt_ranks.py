"""Two-rank checkpoint drive of the port on the CPU: run once per rank
with RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT set. Each rank builds
llama-tiny from its own seed (create_train_state broadcasts rank 0's
weights), trains 3 steps on its half of a seeded batch through
train_loop(ckpt_dir=ROOT, save_every=2) on a gloo data-parallel mesh,
and saves its final parameters to OUT.<rank>.pt.

    python torch_ckpt_ranks.py ROOT OUT
"""

import sys

import numpy as np
import torch
import torch.distributed as td

from tony_tpu_torch import distributed, train
from tony_tpu_torch.models import get_model
from tony_tpu_torch.parallel import MeshSpec


def main(root: str, out: str) -> None:
    # Several ranks share the host's cores: one thread each, not one
    # pool each.
    torch.set_num_threads(1)
    distributed.initialize(device="cpu")
    rank = td.get_rank()
    try:
        mesh = MeshSpec(dp=0).build(device="cpu")
        model = get_model("llama-tiny", device="cpu", dtype=torch.float32,
                          seed=rank)
        state = train.create_train_state(model, train.adamw(1e-3),
                                         mesh=mesh)
        tokens = np.random.RandomState(0).randint(0, 256, (4, 17)).astype(
            np.int32)
        step = train.make_train_step(
            loss_of=lambda logits, b: train.next_token_loss(logits,
                                                            b["x"]),
            mesh=mesh)
        batch = train.global_batch(mesh, {"x": tokens[2 * rank:2 * rank + 2]})
        state, _ = train.train_loop(state, step, [batch] * 3, ckpt_dir=root,
                                    save_every=2)
        torch.save({n: p.detach() for n, p in model.named_parameters()},
                   f"{out}.{rank}.pt")
    finally:
        td.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
