"""Where the port's bf16 quantized logits part from the JAX reference.

Builds llama-tiny (2 layers, bf16, ``quant=True``) in the JAX package,
carries its weights into the PyTorch port, and runs the same tokens as
tests/test_torch_quant.py through three executions: the port, the JAX
module under ``jax.jit``, and the JAX module op by op
(``jax.disable_jit``). It prints JSON lines:

* ``logits``: max|a - b| / max|b| between each pair of executions, for
  the unquantized, the all-projection and the ``lm_head``-only lanes
  (the scanned layout the tests use);
* ``codes``: at the input of each layer's first quantized projection of
  the attention (``attn_norm``) and of the MLP (``mlp_norm``), how many
  bf16 activations and int8 codes of the port differ from each JAX
  execution, and whether the per-tensor scale is equal (unscanned
  layout, whose intermediates flax can capture);
* ``mlp0``: the same count at layer 0's ``w_gate``/``w_up`` outputs and
  at ``w_down``'s input ``silu(gate) · up``.

Runs on the CPU in about half a minute:

    JAX_PLATFORMS=cpu python exp/port_quant_bf16_witness.py
"""

import json
import os
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tony_tpu.models import get_model as jax_model  # noqa: E402
from tony_tpu_torch.models import get_model  # noqa: E402
from tony_tpu_torch.models.convert import load_jax_params  # noqa: E402
from tony_tpu_torch.ops import quant as tq  # noqa: E402

LAYERS = 2
TOKENS = np.random.RandomState(24).randint(0, 256, (2, 24)).astype(np.int32)


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


def build(quant, **kw):
    jm = jax_model("llama-tiny", n_layers=LAYERS, dtype=jnp.bfloat16,
                   quant=quant, **kw)
    params = nn.unbox(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)))["params"]
    tm = get_model("llama-tiny", n_layers=LAYERS, dtype=torch.bfloat16,
                   quant=quant, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def logits():
    for quant in (None, True, ("lm_head",)):
        jm, params, tm = build(quant)
        tok = jnp.asarray(TOKENS)
        jit = np.asarray(jax.jit(jm.apply)({"params": params}, tok))
        with jax.disable_jit():
            eager = np.asarray(jm.apply({"params": params}, tok))
        port = tm(torch.from_numpy(TOKENS)).detach().numpy()
        print(json.dumps({"logits": str(quant), "port_vs_jit": rel(port, jit),
                          "port_vs_eager": rel(port, eager),
                          "jit_vs_eager": rel(eager, jit)}))


def _codes(x: torch.Tensor):
    x2 = x.to(torch.bfloat16).reshape(-1, x.shape[-1])
    s = tq.scale_of(torch.amax(torch.abs(x2)))
    return x2, tq.quantize(x2, s), s


def codes():
    jm, params, tm = build(True, scan_layers=False)

    def run(p, t):
        return jm.apply(p, t, capture_intermediates=True,
                        mutable=["intermediates"])[1]["intermediates"]

    tok = jnp.asarray(TOKENS)
    jit = jax.jit(run)({"params": params}, tok)
    with jax.disable_jit():
        eager = run({"params": params}, tok)
    caps = {}
    for i, blk in enumerate(tm.layers):
        for name in ("attn_norm", "mlp_norm"):
            getattr(blk, name).register_forward_hook(
                lambda m, a, o, key=(name, i): caps.__setitem__(key, o))
    mlp0 = tm.layers[0].mlp
    for name in ("w_gate", "w_up", "w_down"):
        getattr(mlp0, name).register_forward_hook(
            lambda m, a, o, key=name: caps.__setitem__(key, (a[0], o)))
    with torch.no_grad():
        tm(torch.from_numpy(TOKENS))
    for i in range(LAYERS):
        for name in ("attn_norm", "mlp_norm"):
            p2, pq, ps = _codes(caps[(name, i)])
            row = {"codes": f"layer{i}.{name}", "n": p2.numel()}
            for tag, tree in (("jit", jit), ("eager", eager)):
                j2, jq, js = _codes(to_torch(
                    tree[f"layer_{i}"]["block"][name]["__call__"][0]))
                row[tag] = {"bf16_differ": int((p2 != j2).sum()),
                            "codes_differ": int((pq != jq).sum()),
                            "scale_equal": bool(ps == js)}
            print(json.dumps(row))
    ref = eager["layer_0"]["block"]["mlp"]
    row = {"mlp0": "port vs eager"}
    for name, (inp, out) in (("w_gate", caps["w_gate"]),
                             ("w_up", caps["w_up"])):
        row[f"{name}_out_differ"] = int(
            (out.float() != to_torch(ref[name]["__call__"][0])).sum())
    gate = jnp.asarray(ref["w_gate"]["__call__"][0])
    up = jnp.asarray(ref["w_up"]["__call__"][0])
    with jax.disable_jit():
        want = to_torch(nn.silu(gate) * up)
    inp = caps["w_down"][0].float()
    row["w_down_in_differ"] = int((inp != want).sum())
    row["w_down_in_n"] = inp.numel()
    print(json.dumps(row))


if __name__ == "__main__":
    logits()
    codes()
