"""Port parity for the decoder's serving forward
(tony_tpu_torch.models): the port's ``kv=`` forward against the JAX
package's ``model.apply(..., kv=...)`` on the same tokens, positions,
buffers and weights (carried across by load_jax_params), for the scanned
and the unscanned param layouts, plus the pieces (rope, RMSNorm, the
config, the weight conversion)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from tony_tpu.models import get_model as jax_model
from tony_tpu.models import transformer as jtr
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models import transformer as ttr
from tony_tpu_torch.models.convert import load_jax_params, params_from_jax
from tony_tpu_torch.parallel import AXES, MODEL, Mesh

LAYERS = 2


def _jax_tiny(scan: bool, dtype):
    model = jax_model("llama-tiny", n_layers=LAYERS, dtype=dtype,
                      scan_layers=scan)
    params = nn.unbox(model.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 16), jnp.int32)))["params"]
    return model, params


def _port_tiny(params, dtype):
    model = get_model("llama-tiny", n_layers=LAYERS, dtype=dtype,
                      device="cpu")
    return load_jax_params(model, jax.tree.map(np.asarray, params))


def _serve_inputs(seed, cfg, b=3, t=16, ctx=32):
    rng = np.random.RandomState(seed)
    kvd = cfg.n_kv_heads * cfg.head_dim
    tokens = rng.randint(0, cfg.vocab, (b, t)).astype(np.int32)
    # Per-sequence starts; the last sequence's rows run past the buffer
    # end (those rows must write nothing).
    p0 = np.array([0, 5, ctx - 4])[:b, None]
    positions = (p0 + np.arange(t)[None]).astype(np.int32)
    kbuf = rng.randn(LAYERS, b, ctx, kvd).astype(np.float32)
    vbuf = rng.randn(LAYERS, b, ctx, kvd).astype(np.float32)
    return tokens, positions, kbuf, vbuf


def _with_sink(buf):
    """The port's serve buffers: the JAX package's ``ctx`` columns and
    a zero sink column after them."""
    return torch.from_numpy(np.pad(buf, ((0, 0),) * 2 + ((0, 1), (0, 0))))


def _both_forwards(scan, jdtype, tdtype, seed=0):
    jm, params = _jax_tiny(scan, jdtype)
    tm = _port_tiny(params, tdtype)
    tokens, positions, kbuf, vbuf = _serve_inputs(seed, jm.cfg)
    jlog, (jk, jv) = jm.apply(
        {"params": params}, jnp.asarray(tokens),
        positions=jnp.asarray(positions),
        kv=(jnp.asarray(kbuf, jdtype), jnp.asarray(vbuf, jdtype)))
    tlog, (tk, tv) = tm(
        torch.from_numpy(tokens), positions=torch.from_numpy(positions),
        kv=(_with_sink(kbuf).to(tdtype), _with_sink(vbuf).to(tdtype)),
        ctx=kbuf.shape[2])
    return ((np.asarray(jlog), np.asarray(jk.astype(jnp.float32)),
             np.asarray(jv.astype(jnp.float32))),
            (tlog.numpy(), tk.float().numpy(), tv.float().numpy()))


class TestForwardVsJax:
    @pytest.mark.parametrize("scan", [True, False])
    def test_f32(self, scan):
        (jl, jk, jv), (tl, tk, tv) = _both_forwards(scan, jnp.float32,
                                                    torch.float32)
        assert tl.dtype == np.float32 and tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tk, jk, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tv, jv, atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("scan", [True, False])
    def test_bf16(self, scan):
        (jl, _, _), (tl, _, _) = _both_forwards(scan, jnp.bfloat16,
                                                torch.bfloat16, seed=1)
        assert tl.dtype == np.float32
        assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max()

    def test_layer_callable_equals_stacked_buffers(self):
        """The engine hands the forward a per-layer gather callable; it
        must compute exactly what the stacked buffers give."""
        _, params = _jax_tiny(True, jnp.float32)
        tm = _port_tiny(params, torch.float32)
        tokens, positions, kbuf, vbuf = _serve_inputs(2, tm.cfg)
        kb, vb, ctx = _with_sink(kbuf), _with_sink(vbuf), kbuf.shape[2]
        a, (ak, av) = tm(torch.from_numpy(tokens),
                         positions=torch.from_numpy(positions),
                         kv=(kb.clone(), vb.clone()), ctx=ctx)
        b, (bk, bv) = tm(torch.from_numpy(tokens),
                         positions=torch.from_numpy(positions),
                         kv=lambda i: (kb[i].clone(), vb[i].clone()),
                         ctx=ctx)
        assert torch.equal(a, b) and torch.equal(ak, bk) \
            and torch.equal(av, bv)

    def test_rows_past_the_buffer_write_nothing(self):
        _, params = _jax_tiny(True, jnp.float32)
        tm = _port_tiny(params, torch.float32)
        tokens, positions, kbuf, vbuf = _serve_inputs(3, tm.cfg)
        kb, vb, ctx = _with_sink(kbuf), _with_sink(vbuf), kbuf.shape[2]
        bufs = [kb[i].clone() for i in range(LAYERS)]
        tm(torch.from_numpy(tokens), positions=torch.from_numpy(positions),
           kv=lambda i: (bufs[i], vb[i].clone()), ctx=ctx)
        for i in range(LAYERS):
            for s in range(tokens.shape[0]):
                written = set(int(p) for p in positions[s] if p < ctx)
                for p in range(ctx):
                    same = torch.equal(bufs[i][s, p], kb[i, s, p])
                    assert same == (p not in written)


class TestPieces:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("per_seq", [True, False])
    def test_rope_matches_jax(self, dtype, per_seq):
        rng = np.random.RandomState(4)
        x = rng.randn(2, 8, 4, 16).astype(np.float32)
        pos = (rng.randint(0, 100, (2, 8)) if per_seq
               else rng.randint(0, 100, (8,))).astype(np.int32)
        jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
                  else (jnp.bfloat16, torch.bfloat16))
        ref = jtr.rope(jnp.asarray(x, jd), jnp.asarray(pos), 10000.0,
                       seq_axis=1)
        got = ttr.apply_rope(torch.from_numpy(x).to(td),
                             ttr.rope_tables(torch.from_numpy(pos), 16,
                                             10000.0), seq_axis=1)
        assert got.dtype == td
        tol = 1e-5 if dtype == "f32" else 1e-2
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   atol=tol, rtol=tol)

    def test_rope_is_interleaved_not_rotate_half(self):
        x = torch.zeros(1, 1, 1, 4)
        x[..., 0] = 1.0                      # pair (0, 1) holds (1, 0)
        y = ttr.apply_rope(x, ttr.rope_tables(torch.tensor([1]), 4,
                                              10000.0))
        assert y[..., 1].item() == pytest.approx(np.sin(1.0), abs=1e-6)
        assert y[..., 2].item() == 0.0

    def test_rmsnorm_matches_jax(self):
        rng = np.random.RandomState(5)
        x = rng.randn(3, 5, 64).astype(np.float32)
        scale = rng.randn(64).astype(np.float32)
        ref = jtr.RMSNorm(1e-5).apply({"params": {"scale": scale}},
                                      jnp.asarray(x, jnp.bfloat16))
        norm = ttr.RMSNorm(64, 1e-5, torch.device("cpu"))
        with torch.no_grad():
            norm.scale.copy_(torch.from_numpy(scale))
        with torch.no_grad():
            got = norm(torch.from_numpy(x).to(torch.bfloat16))
        assert norm.scale.dtype == torch.float32
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   atol=1e-2, rtol=1e-2)

    def test_config_matches_jax(self):
        jf = {f.name for f in dataclasses.fields(jtr.TransformerConfig)}
        tf = {f.name for f in dataclasses.fields(ttr.TransformerConfig)}
        assert jf == tf
        j, t = jtr.TransformerConfig(), ttr.TransformerConfig()
        for name in jf - {"dtype"}:
            assert getattr(j, name) == getattr(t, name), name
        assert t.dtype == torch.bfloat16
        assert t.head_dim == j.head_dim == 128
        assert t.flops_per_token() == j.flops_per_token()

    def test_tiny_defaults_match_jax(self):
        jm = jax_model("llama-tiny")
        tm = get_model("llama-tiny", device="cpu")
        for name in ("vocab", "dim", "n_layers", "n_heads", "n_kv_heads",
                     "ffn_hidden", "max_seq", "attention", "scan_layers",
                     "remat"):
            assert getattr(jm.cfg, name) == getattr(tm.cfg, name), name

    def test_init_laws(self):
        tm = get_model("llama-tiny", dim=256, n_heads=4, n_kv_heads=4,
                       ffn_hidden=512, device="cpu", seed=3)
        w = tm.layers[0].mlp.w_up.weight.detach()
        # Stored in f32 (the JAX module's param_dtype); a server stores
        # cfg.dtype, which is the same draw cast once.
        assert w.dtype == torch.float32
        served = get_model("llama-tiny", dim=256, n_heads=4, n_kv_heads=4,
                           ffn_hidden=512, device="cpu", seed=3,
                           param_dtype=torch.bfloat16)
        assert torch.equal(served.layers[0].mlp.w_up.weight,
                           w.to(torch.bfloat16))
        assert served.final_norm.scale.dtype == torch.float32
        assert float(w.float().std()) == pytest.approx(256 ** -0.5,
                                                       rel=0.1)
        assert float(w.float().abs().max()) <= 2.1 * 256 ** -0.5 / 0.8796
        assert float(tm.embedding.detach().float().std()) == pytest.approx(
            0.02, rel=0.1)
        assert torch.all(tm.final_norm.scale == 1.0)
        again = get_model("llama-tiny", dim=256, n_heads=4, n_kv_heads=4,
                          ffn_hidden=512, device="cpu", seed=3)
        assert torch.equal(again.lm_head.weight, tm.lm_head.weight)


class TestConvert:
    def test_scanned_and_unscanned_layouts_agree(self):
        _, params = _jax_tiny(True, jnp.float32)
        scanned = jax.tree.map(np.asarray, params)
        unscanned = {k: v for k, v in scanned.items() if k != "layers"}
        for i in range(LAYERS):
            unscanned[f"layer_{i}"] = {"block": jax.tree.map(
                lambda a: a[i], scanned["layers"]["block"])}
        a, b = params_from_jax(scanned), params_from_jax(unscanned)
        assert sorted(a) == sorted(b)
        for name in a:
            assert torch.equal(a[name], b[name]), name
        wq = scanned["layers"]["block"]["attn"]["wq"]["kernel"]
        assert wq.shape == (LAYERS, 64, 64)
        assert torch.equal(a["layers.1.attn.wq.weight"],
                           torch.from_numpy(np.array(wq[1])).t())
        assert torch.equal(a["lm_head.weight"], torch.from_numpy(
            np.array(scanned["lm_head"]["kernel"])).t())

    def test_bfloat16_numpy_arrays(self):
        _, params = _jax_tiny(True, jnp.float32)
        bf = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                          params)
        assert bf["embedding"].dtype.name == "bfloat16"
        tm = get_model("llama-tiny", n_layers=LAYERS, device="cpu",
                       param_dtype=torch.bfloat16)
        load_jax_params(tm, {"params": bf})
        ref = torch.from_numpy(np.asarray(params["embedding"])).to(
            torch.bfloat16)
        assert torch.equal(tm.embedding, ref)
        ref_w = torch.from_numpy(np.asarray(
            params["layers"]["block"]["mlp"]["w_down"]["kernel"][0])).t()
        assert torch.equal(tm.layers[0].mlp.w_down.weight,
                           ref_w.to(torch.bfloat16))

    def test_mismatch_raises(self):
        _, params = _jax_tiny(True, jnp.float32)
        tree = jax.tree.map(np.asarray, params)
        tm = get_model("llama-tiny", n_layers=3, device="cpu")
        with pytest.raises(ValueError, match="missing"):
            load_jax_params(tm, tree)
        del tree["final_norm"]
        with pytest.raises(KeyError, match="final_norm"):
            params_from_jax(tree)


def _tp_mesh():
    shape = dict.fromkeys(AXES, 1)
    shape[MODEL] = 2
    return Mesh(shape=shape, processes=2, device=torch.device("cpu"))


class TestUnported:
    # The mesh and ring attention are ported (tests/test_torch_tp.py,
    # tests/test_torch_ring.py): a MoE decoder on a model axis is not;
    # ring attention without a mesh raises as the reference's assert
    # does; a mesh that is not a built Mesh is refused.
    @pytest.mark.parametrize("kw,exc,match", [
        pytest.param(dict(moe_experts=4, mesh=_tp_mesh()),
                     NotImplementedError, "ROADMAP", id="kw0"),
        pytest.param(dict(attention="ring"), ValueError, "needs cfg.mesh",
                     id="kw1"),
        pytest.param(dict(mesh=object()), TypeError, "Mesh", id="kw2")])
    def test_unported_config_raises(self, kw, exc, match):
        with pytest.raises(exc, match=match):
            get_model("llama-tiny", device="cpu", **kw)

    def test_serve_forward_argument_errors(self):
        tm = get_model("llama-tiny", device="cpu")
        kv = (torch.zeros(2, 1, 16, 32), torch.zeros(2, 1, 16, 32))
        tok = torch.zeros((1, 16), dtype=torch.int32)
        with pytest.raises(ValueError, match="positions"):
            tm(tok, kv=kv)
        with pytest.raises(ValueError, match="targets"):
            tm(tok, tok, positions=tok, kv=kv)
        # No sink column: ctx missing, or as wide as the buffers.
        for ctx in (None, 16):
            with pytest.raises(ValueError, match="sink"):
                tm(tok, positions=tok, kv=kv, ctx=ctx)

    def test_unknown_model(self):
        with pytest.raises(ValueError, match="unknown model"):
            get_model("no-such-model", device="cpu")
