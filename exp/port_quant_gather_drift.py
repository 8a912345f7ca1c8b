"""How far the int8 gather wire lets two ZeRO-3 trajectories drift apart
when they start a last bit apart, on the CPU.

``tests/test_torch_quant_gather.py`` holds the port's ``quant=True``
step against the JAX package's. Run free for 8 SGD steps, llama-tiny's
losses drift apart from step 6 on; this script measures why: it runs
llama-tiny (unscanned, ``xent_chunk=8``, f32) at fsdp 2 for 8 SGD(0.1)
steps of ``make_accum_train_step(microbatches=2, bucket_bytes=1024)``
four ways and prints each step's relative loss difference:

* ``port vs jax`` — the port's step (two gloo ranks running
  ``tests/workloads/torch_zero3_steps.py``) against JAX's on the same
  weights, unquantized and with ``quant=True`` (window 4);
* ``jax vs jax + 1 ulp`` — JAX against JAX from the same weights with
  every parameter moved by -1, 0 or +1 ulp at random (seed 0),
  unquantized and quantized.

A quantized step rounds each weight to a code: a weight a last bit from
a rounding boundary flips its code, a whole quantum (amax / 127), so
last-bit differences grow into loss differences the unquantized step
never shows. Run from the repository root (~2 min):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python3 exp/port_quant_gather_drift.py
"""

import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

import jax
import jax.numpy as jnp
import optax

jax.config.update("jax_platforms", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tony_tpu import parallel as jpar  # noqa: E402
from tony_tpu import train as jtrain  # noqa: E402
from tony_tpu.models import get_model as jax_model  # noqa: E402
from tony_tpu.ops import quant as jq  # noqa: E402
from tony_tpu_torch.models.convert import params_from_jax  # noqa: E402

STEPS, BB, WINDOW = 8, 1024, 4
TOKENS = np.random.RandomState(21).randint(0, 256, (8, 17)).astype(np.int32)


def jax_losses(params, quant):
    mesh = jpar.make_mesh(n_devices=2, fsdp=2)
    model = jax_model("llama-tiny", dtype=jnp.float32, xent_chunk=8,
                      scan_layers=False)
    state = jtrain.create_train_state(model, optax.sgd(0.1),
                                      jnp.asarray(TOKENS),
                                      jax.random.PRNGKey(0), mesh=mesh)
    state = state.replace(params=jax.device_put(
        params, jax.tree.map(lambda a: a.sharding, state.params)))
    if quant:
        state = jq.with_gather_quant(state, mesh, window=WINDOW,
                                     bucket_bytes=BB)
    step = jtrain.make_accum_train_step(
        lambda o, b: o, mesh, microbatches=2, bucket_bytes=BB, quant=quant,
        apply_kwargs_of=lambda b: {"targets": b["x"]}, donate=False)
    out = []
    for _ in range(STEPS):
        state, m = step(state, {"x": jnp.asarray(TOKENS)})
        out.append(float(m["loss"]))
    return out


def port_losses(init, tmp):
    """Both runs of the port on two gloo ranks."""
    np.savez(os.path.join(tmp, "init.npz"), **init)
    np.savez(os.path.join(tmp, "batch.npz"), x=TOKENS)
    accum = {"step": "accum", "microbatches": 2, "steps": STEPS,
             "bucket_bytes": BB, "tx": {"rule": "sgd", "learning_rate": 0.1},
             "dump": False}
    cfg = {"model": "llama-tiny", "targets": True,
           "model_kwargs": {"xent_chunk": 8, "dtype": "float32",
                            "scan_layers": False},
           "dp": 1, "fsdp": 2, "init": os.path.join(tmp, "init.npz"),
           "batch": os.path.join(tmp, "batch.npz"),
           "runs": {"plain": accum,
                    "quant": {**accum, "quant": {"window": WINDOW}}}}
    cpath = os.path.join(tmp, "cfg.json")
    with open(cpath, "w") as fh:
        json.dump(cfg, fh)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "workloads",
                                      "torch_zero3_steps.py"), cpath,
         os.path.join(tmp, f"r{rank}")],
        env=dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                 LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), PYTHONPATH=ROOT))
        for rank in range(2)]
    for p in procs:
        if p.wait(timeout=600):
            raise SystemExit("a rank failed")
    runs = json.load(open(os.path.join(tmp, "r0.json")))["runs"]
    return {k: [m["loss"] for m in runs[k]["metrics"]]
            for k in ("plain", "quant")}


def rel(a, b):
    return " ".join(f"{abs(x - y) / abs(y):.1e}" for x, y in zip(a, b))


def main():
    model = jax_model("llama-tiny", dtype=jnp.float32, xent_chunk=8,
                      scan_layers=False)
    params = jtrain.create_train_state(model, optax.sgd(0.1),
                                       jnp.asarray(TOKENS),
                                       jax.random.PRNGKey(0)).params
    rng = np.random.RandomState(0)

    def ulp(a):
        a = np.asarray(a)
        d = rng.choice([-1, 0, 1], size=a.shape)
        return jnp.asarray(np.where(d > 0, np.nextafter(a, np.inf),
                                    np.where(d < 0, np.nextafter(a, -np.inf),
                                             a)).astype(a.dtype))

    moved = jax.tree.map(ulp, params)
    init = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, params)).items()}
    with tempfile.TemporaryDirectory() as tmp:
        port = port_losses(init, tmp)
    for quant, name in ((False, "plain"), (True, "quant")):
        ref = jax_losses(params, quant)
        print(f"{name}: port vs jax, rel loss a step:        "
              f"{rel(port[name], ref)}")
        print(f"{name}: jax vs jax + 1 ulp, rel loss a step: "
              f"{rel(jax_losses(moved, quant), ref)}")


if __name__ == "__main__":
    main()
