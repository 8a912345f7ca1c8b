"""Port parity for the training attention (tony_tpu_torch.ops.attention):
the port's flash_attention / flash_attention_packed, values and all three
grads, against the JAX package's Pallas kernels run in interpret mode on
the same numpy inputs (as tests/test_ops.py runs them), at test_ops.py's
tolerances: 2e-5 in f32, 2e-2 in bf16, 2e-4 packed against classic. On
the CPU the port runs its plain versions (which follow the kernels'
math block by block); the CUDA kernels are held against those plain
versions on the card (tests/test_torch_cuda.py and chip_smoke.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tony_tpu.ops import attention as jattn
from tony_tpu_torch.ops import attention as tattn
from tony_tpu_torch.ops import flash_attention, flash_attention_packed

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _arrays(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _jax_vjp(fn, args, w, jdtype):
    """Output and the grads of sum(out * w), from the JAX side."""
    out, vjp = jax.vjp(fn, *(jnp.asarray(a, jdtype) for a in args))
    grads = vjp(jnp.asarray(w, out.dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _torch_vjp(fn, args, w, tdtype):
    ts = [torch.from_numpy(a).to(tdtype).requires_grad_() for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(w).to(out.dtype))
    return [x.detach().float().numpy() for x in (out, *(t.grad for t in ts))]


def _classic_case(seed, b, h, hkv, t, tk, d, causal, dtype="f32"):
    q, k, v, w = _arrays(seed, [(b, h, t, d), (b, hkv, tk, d),
                                (b, hkv, tk, d), (b, h, t, d)])
    jd, td, tol = ((jnp.float32, torch.float32, F32) if dtype == "f32"
                   else (jnp.bfloat16, torch.bfloat16, BF16))
    ref = _jax_vjp(lambda q, k, v: jattn.flash_attention(
        q, k, v, causal=causal, block_q=16, block_k=16, interpret=True),
        (q, k, v), w, jd)
    got = _torch_vjp(lambda q, k, v: flash_attention(q, k, v, causal=causal),
                     (q, k, v), w, td)
    for name, a, r in zip(("out", "dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a, r, err_msg=name, **tol)


class TestClassicVsJax:
    @pytest.mark.parametrize("causal", [True, False])
    def test_mha(self, causal):
        _classic_case(0, 2, 3, 3, 64, 64, 16, causal)

    @pytest.mark.parametrize("causal", [True, False])
    def test_gqa(self, causal):
        _classic_case(1, 1, 4, 2, 64, 64, 16, causal)

    def test_ragged_causal_t40(self):
        _classic_case(2, 1, 2, 2, 40, 40, 8, True)

    @pytest.mark.parametrize("causal", [True, False])
    def test_cross_lengths(self, causal):
        """t != tk, neither a block multiple (the JAX side pads and masks;
        the port masks the ragged edge itself); causal is aligned at the
        top left."""
        _classic_case(3, 1, 2, 2, 40, 24, 16, causal)

    @pytest.mark.parametrize("d", [8, 12, 128])
    def test_head_dims(self, d):
        _classic_case(4, 1, 2, 1, 32, 32, d, True)

    def test_bf16(self):
        _classic_case(5, 2, 3, 3, 64, 64, 16, True, dtype="bf16")


def _pack(x):
    b, h, t, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b, t, h * d))


class TestPackedVsJax:
    @pytest.mark.parametrize("hkv", [2, 1])
    def test_packed_gqa(self, hkv):
        b, h, t, d = 1, 4, 32, 128
        q, k, v, w = _arrays(6, [(b, h, t, d), (b, hkv, t, d),
                                 (b, hkv, t, d), (b, h, t, d)])
        args = (_pack(q), _pack(k), _pack(v))
        ref = _jax_vjp(lambda q, k, v: jattn.flash_attention_packed(
            q, k, v, h, causal=True, block_q=16, block_k=16,
            interpret=True), args, _pack(w), jnp.float32)
        got = _torch_vjp(lambda q, k, v: flash_attention_packed(
            q, k, v, h, causal=True), args, _pack(w), torch.float32)
        for name, a, r in zip(("out", "dq", "dk", "dv"), got, ref):
            np.testing.assert_allclose(a, r, err_msg=name, **F32)

    @pytest.mark.parametrize("causal", [True, False])
    def test_packed_matches_classic(self, causal):
        b, h, t, d = 2, 2, 64, 128
        q, k, v, w = _arrays(7, [(b, h, t, d)] * 4)
        packed = _torch_vjp(lambda q, k, v: flash_attention_packed(
            q, k, v, h, causal=causal), (_pack(q), _pack(k), _pack(v)),
            _pack(w), torch.float32)
        classic = _torch_vjp(lambda q, k, v: flash_attention(
            q, k, v, causal=causal), (q, k, v), w, torch.float32)
        for a, c in zip(packed, classic):
            np.testing.assert_allclose(a, _pack(c), atol=2e-4, rtol=2e-4)


class TestPlainFunction:
    def test_gradcheck_f64(self):
        rng = np.random.RandomState(8)
        q, k, v = (torch.from_numpy(rng.randn(*s)).requires_grad_()
                   for s in [(1, 2, 5, 4), (1, 1, 7, 4), (1, 1, 7, 4)])
        for causal in (True, False):
            assert torch.autograd.gradcheck(
                lambda q, k, v: tattn._FlashFn.apply(q, k, v, causal, 0.5),
                (q, k, v))

    def test_lse_and_blocks(self):
        """LSE is the per-row log-sum-exp [b, h, t]; the key-block size of
        the plain version changes rounding only."""
        q, k, v = (torch.from_numpy(a) for a in
                   _arrays(9, [(1, 2, 50, 8), (1, 2, 50, 8), (1, 2, 50, 8)]))
        out, lse = tattn._flash_fwd_plain(q, k, v, True, 8 ** -0.5)
        out16, lse16 = tattn._flash_fwd_plain(q, k, v, True, 8 ** -0.5,
                                              block_k=16)
        s = (q @ k.transpose(-1, -2)) * 8 ** -0.5
        s = s.masked_fill(~torch.ones(50, 50, dtype=torch.bool).tril(),
                          float("-inf"))
        assert lse.shape == (1, 2, 50) and lse.dtype == torch.float32
        np.testing.assert_allclose(lse.numpy(),
                                   torch.logsumexp(s, -1).numpy(), **F32)
        np.testing.assert_allclose(out16.numpy(), out.numpy(), **F32)
        np.testing.assert_allclose(lse16.numpy(), lse.numpy(), **F32)

    def test_causal_keys_past_every_row_get_zero_grads(self):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in
                   _arrays(10, [(1, 2, 8, 8), (1, 2, 20, 8), (1, 2, 20, 8)]))
        flash_attention(q, k, v, causal=True).sum().backward()
        assert torch.all(k.grad[:, :, 8:] == 0)
        assert torch.all(v.grad[:, :, 8:] == 0)
        assert torch.any(v.grad[:, :, :8] != 0)

    def test_cpu_counts_no_launch(self):
        before = dict(tattn.LAUNCHES)
        q = torch.randn(1, 2, 16, 8, requires_grad=True)
        flash_attention(q, q, q).sum().backward()
        assert tattn.LAUNCHES == before


class TestValidation:
    def test_argument_errors(self):
        q = torch.zeros(1, 4, 16, 16)
        with pytest.raises(ValueError, match="multiple of kv heads"):
            flash_attention(q, torch.zeros(1, 3, 16, 16),
                            torch.zeros(1, 3, 16, 16))
        with pytest.raises(ValueError, match="must match"):
            flash_attention(q, torch.zeros(1, 2, 16, 16),
                            torch.zeros(1, 2, 8, 16))
        with pytest.raises(ValueError, match=r"\[b, h, t, d\]"):
            flash_attention(q[0], q[0], q[0])
        p = torch.zeros(1, 16, 64)
        with pytest.raises(ValueError, match="not divisible by heads"):
            flash_attention_packed(p, p, p, 3)
        with pytest.raises(ValueError, match="head-multiple"):
            flash_attention_packed(p, torch.zeros(1, 16, 24),
                                   torch.zeros(1, 16, 24), 4)
        with pytest.raises(ValueError, match="must match"):
            flash_attention_packed(p, p, torch.zeros(1, 8, 64), 4)

    def test_unsupported_device_raises(self):
        q = torch.zeros((1, 2, 16, 16), device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            flash_attention(q, q, q)

    def test_kernel_checks_reject_off_shapes_before_launch(self):
        """The CUDA wrappers' own checks run before any build or launch,
        so they are testable without a card (on meta tensors)."""
        q = torch.zeros((1, 2, 16, 256), device="meta")
        with pytest.raises(ValueError, match="up to 128"):
            tattn._flash_fwd_cuda(q, q, q, True, 1.0)
        q = torch.zeros((1, 2, 16, 16), dtype=torch.float16, device="meta")
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            tattn._flash_fwd_cuda(q, q, q, True, 1.0)
        q = torch.zeros((1, 2, 16, 16), device="meta")
        k = torch.zeros((1, 2, 16, 16), dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="one dtype"):
            tattn._flash_bwd_cuda(q, k, k, q, q[..., 0], q, True, 1.0)
