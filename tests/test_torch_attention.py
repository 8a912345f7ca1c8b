"""Port parity for the serving attention (tony_tpu_torch.ops.attention):
the plain flash-decode path against the JAX package's flash_decode (its
XLA path and its Pallas kernel in interpret mode) on the same numpy
inputs, against the port's own reference_attention, and the argument
checks. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tony_tpu.ops import attention as jattn
from tony_tpu_torch.ops import attention as tattn
from tony_tpu_torch.ops import flash_decode, reference_attention

CASES = [(4, 4, 16), (4, 2, 16), (4, 1, 32)]


def _inputs(seed, b, h, hkv, t, d, ctx, ragged=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, t, d).astype(np.float32)
    k = rng.randn(b, hkv, ctx, d).astype(np.float32)
    v = rng.randn(b, hkv, ctx, d).astype(np.float32)
    if ragged:
        # Consecutive rows from a per-sequence start, some running past
        # the cache end (the decode block's padding rows near ctx_max).
        p0 = rng.randint(0, ctx, (b, 1))
        pos = (p0 + np.arange(t)[None]).astype(np.int32)
    else:
        pos = rng.randint(0, ctx, (b, t)).astype(np.int32)
    return q, k, v, pos


def _jax(q, k, v, pos, dtype, **kw):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out = jattn.flash_decode(*args, jnp.asarray(pos), **kw)
    return np.asarray(out.astype(jnp.float32))


def _torch(q, k, v, pos, dtype, **kw):
    args = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return flash_decode(*args, torch.from_numpy(pos), **kw).float().numpy()


class TestFlashDecodeVsJax:
    @pytest.mark.parametrize("interpret", [None, True])
    @pytest.mark.parametrize("h,hkv,block_k", CASES)
    def test_f32(self, h, hkv, block_k, interpret):
        q, k, v, pos = _inputs(0, 3, h, hkv, 16, 16, 64)
        ref = _jax(q, k, v, pos, jnp.float32, block_k=block_k,
                   interpret=interpret)
        got = _torch(q, k, v, pos, torch.float32, block_k=block_k)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("interpret", [None, True])
    @pytest.mark.parametrize("h,hkv,block_k", CASES)
    def test_bf16(self, h, hkv, block_k, interpret):
        q, k, v, pos = _inputs(1, 3, h, hkv, 16, 16, 64)
        ref = _jax(q, k, v, pos, jnp.bfloat16, block_k=block_k,
                   interpret=interpret)
        got = _torch(q, k, v, pos, torch.bfloat16, block_k=block_k)
        np.testing.assert_allclose(got, ref, atol=1e-2, rtol=1.6e-2)

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_ragged_positions_gqa(self, dtype):
        q, k, v, pos = _inputs(2, 4, 8, 2, 16, 32, 80, ragged=True)
        jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
                  else (jnp.bfloat16, torch.bfloat16))
        tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "f32"
               else dict(atol=1e-2, rtol=1.6e-2))
        ref = _jax(q, k, v, pos, jd)
        np.testing.assert_allclose(_torch(q, k, v, pos, td), ref, **tol)

    def test_ctx_off_the_block_tile(self):
        """ctx with no 16-multiple divisor: both packages fall back to one
        whole-cache block."""
        q, k, v, pos = _inputs(3, 2, 4, 2, 8, 16, 40)
        ref = _jax(q, k, v, pos, jnp.float32)
        np.testing.assert_allclose(_torch(q, k, v, pos, torch.float32),
                                   ref, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("limit,t", [(128, 2048), (128, 64), (128, 40),
                                         (16, 48), (256, 8), (64, 96)])
    def test_fit_block_matches(self, limit, t):
        assert tattn._fit_block(limit, t) == jattn._fit_block(limit, t)

    def test_mask_update_matches(self):
        rng = np.random.RandomState(4)
        s = rng.randn(2, 3, 8, 16).astype(np.float32)
        q_pos = rng.randint(0, 16, (2, 3, 8, 1)).astype(np.int32)
        k_pos = np.arange(16, dtype=np.int32)
        m = rng.randn(2, 3, 8, 1).astype(np.float32)
        m[0, 0, 0, 0] = -1e30
        l = np.abs(rng.randn(2, 3, 8, 1)).astype(np.float32)
        ref = jattn._decode_mask_update(*(jnp.asarray(x) for x in
                                          (s, q_pos, k_pos, m, l)))
        got = tattn._decode_mask_update(*(torch.from_numpy(x) for x in
                                          (s, q_pos, k_pos, m, l)))
        for a, b in zip(ref, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       atol=1e-6, rtol=1e-6)


class TestFlashDecodeSpec:
    def test_matches_reference_attention(self):
        rng = np.random.RandomState(1)
        b, h, hkv, t, d, ctx = 2, 4, 2, 16, 16, 48
        q = torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32))
        k = torch.from_numpy(rng.randn(b, hkv, ctx, d).astype(np.float32))
        v = torch.from_numpy(rng.randn(b, hkv, ctx, d).astype(np.float32))
        # Rows are the last t positions of a ctx-long causal sequence.
        pos = torch.arange(ctx - t, ctx, dtype=torch.int32)[None].expand(
            b, t)
        dec = flash_decode(q, k, v, pos, block_k=16)
        qfull = torch.zeros(b, h, ctx, d)
        qfull[:, :, ctx - t:] = q
        ref = reference_attention(qfull, k, v, causal=True)[:, :, ctx - t:]
        np.testing.assert_allclose(dec.numpy(), ref.numpy(), atol=2e-5,
                                   rtol=2e-5)

    def test_reference_attention_matches_jax(self):
        rng = np.random.RandomState(5)
        q = rng.randn(2, 4, 24, 16).astype(np.float32)
        k = rng.randn(2, 2, 24, 16).astype(np.float32)
        v = rng.randn(2, 2, 24, 16).astype(np.float32)
        for causal in (True, False):
            ref = jattn.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), causal=causal)
            got = reference_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=2e-5, rtol=2e-5)

    def test_strided_views_match_contiguous(self):
        """The serving forward passes [b, ctx, hkv·d] buffers viewed as
        [b, hkv, ctx, d]; the plain path reads the views as they are."""
        rng = np.random.RandomState(6)
        b, h, hkv, t, d, ctx = 2, 4, 2, 16, 8, 32
        q = torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32))
        kb = torch.from_numpy(rng.randn(b, ctx, hkv * d).astype(np.float32))
        vb = torch.from_numpy(rng.randn(b, ctx, hkv * d).astype(np.float32))
        pos = torch.from_numpy(rng.randint(0, ctx, (b, t)).astype(np.int32))
        views = (q.transpose(1, 2), kb.view(b, ctx, hkv, d).transpose(1, 2),
                 vb.view(b, ctx, hkv, d).transpose(1, 2))
        got = flash_decode(*views, pos, block_k=16)
        ref = flash_decode(*(x.contiguous() for x in views), pos,
                           block_k=16)
        assert torch.equal(got, ref)

    def test_rows_are_independent(self):
        """A row's bits do not depend on t or on the other rows."""
        rng = np.random.RandomState(7)
        b, h, hkv, d, ctx = 2, 4, 2, 16, 64
        k = torch.from_numpy(rng.randn(b, hkv, ctx, d).astype(np.float32))
        v = torch.from_numpy(rng.randn(b, hkv, ctx, d).astype(np.float32))
        q64 = torch.from_numpy(rng.randn(b, h, 64, d).astype(np.float32))
        pos64 = torch.from_numpy(rng.randint(0, ctx, (b, 64))
                                 .astype(np.int32))
        o64 = flash_decode(q64, k, v, pos64, block_k=16)
        o16 = flash_decode(q64[:, :, 16:32].contiguous(), k, v,
                           pos64[:, 16:32].contiguous(), block_k=16)
        assert torch.equal(o16, o64[:, :, 16:32])

    def test_launch_count_untouched_on_cpu(self):
        before = tattn.LAUNCHES["flash_decode"]
        q, k, v, pos = _inputs(8, 1, 2, 2, 8, 8, 16)
        _torch(q, k, v, pos, torch.float32)
        assert tattn.LAUNCHES["flash_decode"] == before


class TestFlashDecodeValidation:
    def test_validation_errors(self):
        q = torch.zeros((1, 4, 16, 16), dtype=torch.bfloat16)
        k = torch.zeros((1, 3, 32, 16), dtype=torch.bfloat16)
        pos = torch.zeros((1, 16), dtype=torch.int32)
        with pytest.raises(ValueError, match="multiple of kv heads"):
            flash_decode(q, k, k, pos)
        k2 = torch.zeros((1, 2, 32, 16), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="q_positions"):
            flash_decode(q, k2, k2, torch.zeros((1, 8), dtype=torch.int32))
        with pytest.raises(ValueError, match="must match"):
            flash_decode(q, k2, torch.zeros((1, 2, 16, 16),
                                            dtype=torch.bfloat16), pos)
        with pytest.raises(ValueError, match=r"\[b, h, t, d\]"):
            flash_decode(q[0], k2, k2, pos)

    def test_unsupported_device_raises(self):
        q = torch.zeros((1, 4, 16, 16), device="meta")
        k = torch.zeros((1, 2, 32, 16), device="meta")
        pos = torch.zeros((1, 16), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            flash_decode(q, k, k, pos)

    def test_kernel_checks_reject_off_shapes_before_launch(self):
        """The CUDA wrapper's own checks run before any build or launch,
        so they are testable without a card (on meta tensors)."""
        pos = torch.zeros((1, 16), dtype=torch.int32, device="meta")
        q = torch.zeros((1, 4, 16, 12), device="meta")
        k = torch.zeros((1, 2, 32, 12), device="meta")
        with pytest.raises(ValueError, match="multiple of 8"):
            tattn._decode_cuda(q, k, k, pos, 1.0)
        q = torch.zeros((1, 4, 16, 16), dtype=torch.float16, device="meta")
        k = torch.zeros((1, 2, 32, 16), dtype=torch.float16, device="meta")
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            tattn._decode_cuda(q, k, k, pos, 1.0)
        q = torch.zeros((1, 4, 16, 16), device="meta")
        kt = torch.zeros((1, 2, 16, 32), device="meta").transpose(2, 3)
        with pytest.raises(ValueError, match="contiguous"):
            tattn._decode_cuda(q, kt, kt, pos, 1.0)
