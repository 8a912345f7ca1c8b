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


def _packed_view(b, t, h, d, device="cpu"):
    x = torch.zeros((b, t, h * d), dtype=torch.bfloat16, device=device)
    return x.unflatten(2, (h, d)).transpose(1, 2)


def _strided(size, stride, offset=0):
    n = offset + 1 + sum((s - 1) * st for s, st in zip(size, stride))
    return torch.zeros(n, dtype=torch.bfloat16)[offset:].as_strided(
        size, stride)


class TestBackwardLoader:
    """The host rule for the bf16 kernels' 16-byte ``cp.async`` loader
    (``_vec_ok``; the forward and the backward pair), and ``_for_mma``,
    which hands the kernels the layouts the model gives as they are and
    copies or zero-pads any other once, before the launch."""

    @pytest.mark.parametrize("make,vec", [
        (lambda: _packed_view(2, 64, 4, 128), True),
        (lambda: _packed_view(2, 2048, 32, 128, device="meta"), True),
        (lambda: _packed_view(1, 40, 3, 8), True),
        (lambda: torch.zeros((2, 4, 40, 64), dtype=torch.bfloat16), True),
        (lambda: torch.zeros((1, 2, 33, 16), dtype=torch.bfloat16), True),
        (lambda: _strided((1, 1, 16, 8), (3, 5, 8, 1)), True),
        (lambda: torch.zeros((2, 4, 64, 32), dtype=torch.bfloat16)
         .transpose(-1, -2).transpose(-1, -2).contiguous(), True),
        # transposed: the feature stride is not 1
        (lambda: torch.zeros((2, 4, 32, 64), dtype=torch.bfloat16)
         .transpose(-1, -2), False),
        # zero-stride expand (dO of out.sum() from autograd)
        (lambda: torch.ones((), dtype=torch.bfloat16).expand(2, 4, 64, 32),
         False),
        # one row broadcast over b, h and t: 16-byte copies of that row
        (lambda: torch.ones((1, 1, 1, 32), dtype=torch.bfloat16)
         .expand(2, 4, 64, 32), True),
        # d % 8 != 0
        (lambda: torch.zeros((1, 2, 70, 12), dtype=torch.bfloat16), False),
        (lambda: _packed_view(1, 16, 4, 12), False),
        # a row stride that is not 16 bytes
        (lambda: _strided((1, 2, 16, 8), (640, 320, 20, 1)), False),
        # a head stride that is not 16 bytes
        (lambda: _strided((1, 2, 16, 8), (640, 300, 8, 1)), False),
        # a base that is not 16-byte aligned
        (lambda: _strided((1, 2, 16, 8), (256, 128, 8, 1), offset=1),
         False),
    ])
    def test_vec_ok(self, make, vec):
        assert tattn._vec_ok(make()) is vec

    def test_all_four_operands_decide(self):
        """Each operand is judged on its own: a conforming one is passed
        through untouched, a transposed or zero-stride one is copied to a
        contiguous tensor with the same values, which then conforms."""
        gen = torch.Generator().manual_seed(0)
        x = torch.randn((1, 64, 4 * 64), generator=gen).to(torch.bfloat16)
        q = x.unflatten(2, (4, 64)).transpose(1, 2)
        assert tattn._for_mma(q, 64) is q
        for odd in (q.transpose(-1, -2).contiguous().transpose(-1, -2),
                    torch.ones((), dtype=torch.bfloat16).expand(q.shape)):
            assert not tattn._vec_ok(odd)
            got = tattn._for_mma(odd, 64)
            assert got.is_contiguous() and tattn._vec_ok(got)
            assert torch.equal(got, odd)

    def test_for_mma_copies_an_unaligned_contiguous_operand(self):
        """A contiguous view whose base is off a 16-byte boundary is
        copied too (``.contiguous()`` alone would hand it back as is)."""
        x = torch.arange(1 + 2 * 16 * 8, dtype=torch.float32).to(
            torch.bfloat16)[1:].view(1, 2, 16, 8)
        assert x.is_contiguous() and not tattn._vec_ok(x)
        got = tattn._for_mma(x, 8)
        assert tattn._vec_ok(got) and torch.equal(got, x)

    @pytest.mark.parametrize("d,d8", [(8, 8), (12, 16), (5, 8), (20, 24)])
    def test_for_mma_pads_d_to_a_multiple_of_8(self, d, d8):
        """d % 8 != 0 (the tests' odd widths) is zero-padded on the host:
        the kernels see d8 features, of which the last d8 - d are zero,
        so every product (S, dP, D, dS K, P^T dO, dS^T Q) is unchanged."""
        gen = torch.Generator().manual_seed(d)
        x = torch.randn((1, 2, 10, d), generator=gen).to(torch.bfloat16)
        for view in (x, x.transpose(-1, -2).contiguous().transpose(-1, -2)):
            got = tattn._for_mma(view, d8)
            assert got.shape == (1, 2, 10, d8) and tattn._vec_ok(got)
            assert torch.equal(got[..., :d], x)
            assert not torch.any(got[..., d:])

    @pytest.mark.parametrize("d,layout", [
        (64, "packed"), (64, "transposed_do"), (12, "contiguous"),
        (12, "transposed_q")])
    def test_bf16_wrapper_hands_the_kernels_fitting_operands(
            self, monkeypatch, d, layout):
        """``_flash_bwd_cuda`` with the launches stubbed on CPU tensors:
        each bf16 launch sees d rounded up to a multiple of 8 and only
        operands ``_vec_ok`` takes, and the grads come back at width d in
        q's, k's and v's own layouts."""
        d8 = -(-d // 8) * 8
        seen = []

        def launch(lib, fn_name, counter, args, dims, tensors):
            assert dims[5] == d8 and all(tattn._vec_ok(x) for x in tensors)
            for out in tensors[-2 if counter.endswith("dkv") else -1:]:
                out.copy_(torch.arange(1, d8 + 1).expand(out.shape))
            seen.append(counter)

        monkeypatch.setattr(tattn, "_attn_lib", lambda: None)
        monkeypatch.setattr(tattn, "_launch", launch)
        if layout == "packed":
            q, k, v, o, do = (_packed_view(1, 16, 2, d) for _ in range(5))
        else:
            q, k, v, o, do = (torch.zeros((1, 2, 16, d), dtype=torch.bfloat16)
                              for _ in range(5))
        if layout == "transposed_do":
            do = do.transpose(-1, -2).contiguous().transpose(-1, -2)
        if layout == "transposed_q":
            q = q.transpose(-1, -2).contiguous().transpose(-1, -2)
        lse = torch.zeros((1, 2, 16))
        grads = tattn._flash_bwd_cuda(q, k, v, o, lse, do, True, 1.0)
        assert seen == ["flash_attention_bwd_dq", "flash_attention_bwd_dkv"]
        for grad, x in zip(grads, (q, k, v)):
            assert grad.shape == x.shape and grad.stride() == x.stride()
            assert torch.equal(grad, torch.arange(1, d + 1).to(
                torch.bfloat16).expand(x.shape))

    @pytest.mark.parametrize("d,layout", [
        (64, "packed"), (128, "packed"), (12, "contiguous"),
        (16, "transposed_q"), (12, "transposed_q"), (16, "unaligned_q")])
    def test_bf16_forward_hands_the_kernel_fitting_operands(
            self, monkeypatch, d, layout):
        """``_flash_fwd_cuda`` with the launch stubbed on CPU tensors: the
        bf16 launch sees d rounded up to a multiple of 8 and only operands
        ``_vec_ok`` takes; O comes back at width d in q's own layout, LSE
        as contiguous f32 [B, H, T]. The packed views the model hands over
        are launched as they are, O written in place: nothing copied."""
        d8 = -(-d // 8) * 8
        launched = []

        def launch(lib, fn_name, counter, args, dims, tensors):
            assert counter == "flash_attention_fwd" and dims[5] == d8
            assert all(tattn._vec_ok(x) for x in tensors)
            tensors[-1].copy_(torch.arange(1, d8 + 1).expand(
                tensors[-1].shape))
            launched.append(tensors)

        monkeypatch.setattr(tattn, "_attn_lib", lambda: None)
        monkeypatch.setattr(tattn, "_launch", launch)
        if layout == "packed":
            q, k, v = (_packed_view(1, 16, 2, d) for _ in range(3))
        else:
            q, k, v = (torch.zeros((1, 2, 16, d), dtype=torch.bfloat16)
                       for _ in range(3))
        if layout == "transposed_q":
            q = q.transpose(-1, -2).contiguous().transpose(-1, -2)
        if layout == "unaligned_q":
            q = torch.zeros(1 + q.numel(), dtype=torch.bfloat16)[1:].view(
                q.shape)
        assert tattn._vec_ok(q) is (layout == "packed")
        out, lse = tattn._flash_fwd_cuda(q, k, v, True, 1.0)
        assert len(launched) == 1
        assert out.shape == q.shape and out.stride() == q.stride()
        assert torch.equal(out, torch.arange(1, d + 1).to(
            torch.bfloat16).expand(q.shape))
        assert lse.shape == (1, 2, 16) and lse.dtype == torch.float32
        assert lse.is_contiguous()
        if layout == "packed":
            assert all(x is y for x, y in zip(launched[0], (q, k, v)))
            assert launched[0][3].data_ptr() == out.data_ptr()

    def test_f32_forward_launches_the_operands_as_given(self, monkeypatch):
        """The f32 forward (CUDA cores) takes any strides and d: q, k and v
        reach the launch as they are, and O is written in q's layout."""
        launched = []
        monkeypatch.setattr(tattn, "_attn_lib", lambda: None)
        monkeypatch.setattr(tattn, "_launch", lambda *a: launched.append(
            a[-1]))
        q = torch.zeros((1, 2, 16, 12)).transpose(-1, -2).contiguous() \
            .transpose(-1, -2)
        k = v = torch.zeros((1, 1, 16, 12))
        out, _ = tattn._flash_fwd_cuda(q, k, v, True, 1.0)
        assert all(x is y for x, y in zip(launched[0], (q, k, v)))
        assert launched[0][3] is out and out.stride() == q.stride()
