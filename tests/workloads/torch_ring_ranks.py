"""One rank of the port's ring attention, for ``tests/test_torch_ring.py``
(gloo ranks on the CPU).

Usage: ``python torch_ring_ranks.py <config.json> <out prefix>``, with
the PyTorchRuntime env (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``). The config lists ``cases``, each on its own mesh
``MeshSpec(dp=, sp=, tp=)`` over the whole world: global q, k, v (and a
weight ``w`` for the loss ``Σ out·w``) made from ``seed`` with numpy at
``shape`` ``[b, h, hkv, t, d]``, ``causal``, and whether to take grads.
Each rank runs ``ring_attention_sharded`` on its block and writes
``<prefix>.<case>.r<rank>.npz``: its coordinates, its output block and,
with grads, its share of dq, dk, dv of the global arrays (the ranks'
shares sum to the grads of ``Σ out·w``). Imports only the port, torch
and numpy.
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as td

from tony_tpu_torch import distributed as dist
from tony_tpu_torch.parallel import AXES, MeshSpec
from tony_tpu_torch.parallel.ring_attention import (local_block,
                                                    ring_attention_sharded)


def inputs(case):
    b, h, hkv, t, d = case["shape"]
    rs = np.random.RandomState(case["seed"])
    q = rs.standard_normal((b, h, t, d)).astype(np.float32)
    k = rs.standard_normal((b, hkv, t, d)).astype(np.float32)
    v = rs.standard_normal((b, hkv, t, d)).astype(np.float32)
    w = rs.standard_normal((b, h, t, d)).astype(np.float32)
    if case.get("qkv_same"):
        k = v = q
    return q, k, v, w


def main():
    cfg = json.loads(open(sys.argv[1]).read())
    out = sys.argv[2]
    torch.set_num_threads(1)
    assert dist.initialize(device="cpu"), "expected a multi-process env"
    rank = td.get_rank()
    meshes = {}
    for case in cfg["cases"]:
        key = (case.get("dp", 0), case.get("sp", 1), case.get("tp", 1))
        if key not in meshes:
            meshes[key] = MeshSpec(dp=key[0], sp=key[1],
                                   tp=key[2]).build(device="cpu")
    for case in cfg["cases"]:
        mesh = meshes[(case.get("dp", 0), case.get("sp", 1),
                       case.get("tp", 1))]
        q, k, v, w = (torch.from_numpy(x) for x in inputs(case))
        grads = case.get("grads", False)
        if grads:
            q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
        got = ring_attention_sharded(q, k, v, mesh,
                                     causal=case.get("causal", True))
        res = {"out": got.detach().numpy(),
               "coords": np.array([mesh.coords()[a] for a in AXES])}
        if grads:
            from tony_tpu_torch.parallel import BATCH_AXES, MODEL, SEQ
            w_local = local_block(w, mesh, {0: BATCH_AXES, 1: (MODEL,),
                                            2: (SEQ,)})
            (got * w_local).sum().backward()
            res.update(dq=q.grad.numpy(), dk=k.grad.numpy(),
                       dv=v.grad.numpy())
        np.savez(f"{out}.{case['name']}.r{rank}.npz", **res)
    td.barrier()
    td.destroy_process_group()


if __name__ == "__main__":
    main()
