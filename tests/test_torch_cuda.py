"""Port kernels on the card: each CUDA kernel against its plain PyTorch
version at small shapes. These need an NVIDIA GPU and nvcc; without a
card they skip (decided inside the fixture, never at import). Run on
the card with::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import functools
import math
import time
import warnings

import pytest
import torch

from tony_tpu_torch.ops import LAUNCHES
from tony_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, b, h, hkv, t, d, ctx, dtype):
    q = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype)
    kb = torch.randn((b, ctx, hkv * d), generator=gen,
                     device="cuda").to(dtype)
    vb = torch.randn((b, ctx, hkv * d), generator=gen,
                     device="cuda").to(dtype)
    pos = torch.randint(0, ctx + 8, (b, t), generator=gen, device="cuda",
                        dtype=torch.int32)
    return (q.transpose(1, 2), kb.view(b, ctx, hkv, d).transpose(1, 2),
            vb.view(b, ctx, hkv, d).transpose(1, 2), pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,t,d,ctx", [
    (3, 4, 4, 16, 16, 64), (2, 8, 2, 5, 64, 100), (1, 4, 1, 33, 256, 40),
    (2, 2, 2, 16, 8, 17)])
def test_flash_decode_kernel_vs_plain(gen, dtype, b, h, hkv, t, d, ctx):
    q, k, v, pos = _inputs(gen, b, h, hkv, t, d, ctx, dtype)
    before = LAUNCHES["flash_decode"]
    out = attn.flash_decode(q, k, v, pos)
    assert LAUNCHES["flash_decode"] == before + 1
    ref = attn._decode_plain(q, k, v, pos, d ** -0.5, ctx)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7 * float(
        ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= tol


def test_flash_decode_rows_are_independent(gen):
    q, k, v, pos = _inputs(gen, 2, 8, 2, 48, 64, 96, torch.bfloat16)
    whole = attn.flash_decode(q, k, v, pos)
    part = attn.flash_decode(q[:, :, 20:36], k, v, pos[:, 20:36].clone())
    assert torch.equal(part, whole[:, :, 20:36])


def test_flash_decode_kernel_rejects_off_shapes(gen):
    q, k, v, pos = _inputs(gen, 1, 4, 2, 16, 16, 32, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attn.flash_decode(q, k, v, pos)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_runs_the_tensor_core_kernel_in_bf16(gen, dtype):
    """bf16 launches the tensor-core kernel (and its combine kernel where
    the plan splits the cache) and never the CUDA-core one; f32 the
    CUDA-core one and no mma kernel."""
    q, k, v, pos = _inputs(gen, 1, 4, 4, 16, 128, 600, dtype)
    counts = _device_kernel_counts(lambda: attn.flash_decode(q, k, v, pos))
    names = " ".join(counts)
    mma, core = "flash_decode_mma_kernel<128, 1>", "flash_decode_kernel"
    want, never = (mma, core) if dtype == torch.bfloat16 else (core, mma)
    assert sum(n for key, n in counts.items() if want in key) == 1, counts
    assert never.split("<")[0] not in names, counts
    combine = sum(n for key, n in counts.items()
                  if "flash_decode_combine_kernel" in key)
    assert combine == (dtype == torch.bfloat16), counts


def test_flash_decode_rows_do_not_depend_on_the_split(gen):
    """One sequence's rows alone (b=1: the cache split over many blocks)
    and inside a b=16 launch (unsplit), and at forced split counts, give
    the same bits; so do two launches."""
    q, k, v, pos = _inputs(gen, 16, 32, 32, 16, 128, 1100, torch.bfloat16)
    dev = torch.cuda.current_device()
    plans = [attn._decode_plan_on(dev, b, 32, 32, 16, 128, 1100)
             for b in (1, 16)]
    assert plans[0].splits > 1 and plans[1].splits == 1, plans
    whole = attn.flash_decode(q, k, v, pos)
    assert torch.equal(whole, attn.flash_decode(q, k, v, pos))
    one = attn.flash_decode(q[5:6], k[5:6], v[5:6], pos[5:6].clone())
    assert torch.equal(one, whole[5:6])
    for splits in (2, 3, 5):
        assert torch.equal(attn._decode_cuda(q, k, v, pos, 128 ** -0.5,
                                             splits=splits), whole)


@pytest.mark.parametrize("splits", [1, 3])
def test_flash_decode_row_with_a_negative_position_is_zero(gen, splits):
    """A row that admits no key gives 0, as the chunked fold's plain
    model (``_decode_chunked_plain``) defines it, also where every row of
    a block is such a row; the other rows match the model."""
    q, k, v, pos = _inputs(gen, 2, 4, 4, 16, 64, 600, torch.bfloat16)
    pos[0, 3] = -1
    pos[1] = -1
    out = attn._decode_cuda(q, k, v, pos, 64 ** -0.5, splits=splits)
    ref = attn._decode_chunked_plain(q, k, v, pos, 64 ** -0.5,
                                     attn._DECODE_CHUNK)
    torch.cuda.synchronize()
    assert not out[0, :, 3].any() and not out[1].any()
    assert float((out.float() - ref.float()).abs().max()) <= 2 ** -7 * float(
        ref.float().abs().max())


def _flash_inputs(gen, b, h, hkv, t, tk, d, dtype, packed):
    """q/k/v/dO as the model hands them over: packed [b, t, h·d]
    projections viewed as [b, h, t, d], or contiguous [b, h, t, d]."""
    def make(n, length):
        if packed:
            x = torch.randn((b, length, n * d), generator=gen, device="cuda")
            return x.to(dtype).unflatten(2, (n, d)).transpose(1, 2)
        return torch.randn((b, n, length, d), generator=gen,
                           device="cuda").to(dtype)
    return make(h, t), make(hkv, tk), make(hkv, tk), make(h, t)


def _tol(ref, dtype):
    scale = float(ref.float().abs().max())
    if dtype == torch.float32:
        return 1e-5 * max(1.0, scale)
    return 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


FLASH_CASES = [  # b, h, hkv, t, tk, d, causal, packed
    (2, 4, 4, 128, 128, 128, True, True), (1, 4, 2, 96, 96, 128, True, True),
    (2, 2, 2, 40, 40, 64, True, False), (1, 4, 1, 100, 70, 16, False, False),
    (1, 2, 2, 70, 40, 12, True, False), (1, 2, 1, 200, 200, 8, True, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,t,tk,d,causal,packed", FLASH_CASES)
def test_flash_attention_kernels_vs_plain(gen, dtype, b, h, hkv, t, tk, d,
                                          causal, packed):
    q, k, v, do = _flash_inputs(gen, b, h, hkv, t, tk, d, dtype, packed)
    scale = d ** -0.5
    n0 = dict(LAUNCHES)
    out, lse = attn._flash_fwd_cuda(q, k, v, causal, scale)
    dq, dk, dv = attn._flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert LAUNCHES[name] == n0[name] + 1
    ref_o, ref_lse = attn._flash_fwd_plain(q, k, v, causal, scale)
    ref_dq, dsum = attn._flash_bwd_dq_plain(q, k, v, ref_o, do, ref_lse,
                                            causal, scale)
    ref_dk, ref_dv = attn._flash_bwd_dkv_plain(q, k, v, do, ref_lse, dsum,
                                               causal, scale)
    torch.cuda.synchronize()
    assert out.stride() == q.stride() and dq.stride() == q.stride()
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * max(
        1.0, float(ref_lse.abs().max()))
    for got, ref in ((out, ref_o), (dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == dtype and got.shape == ref.shape
        assert float((got.float() - ref.float()).abs().max()) <= _tol(
            ref, dtype)


def test_flash_attention_dkv_is_deterministic(gen):
    q, k, v, do = _flash_inputs(gen, 1, 8, 2, 256, 256, 128, torch.bfloat16,
                                True)
    out, lse = attn._flash_fwd_cuda(q, k, v, True, 128 ** -0.5)
    a = attn._flash_bwd_cuda(q, k, v, out, lse, do, True, 128 ** -0.5)
    b = attn._flash_bwd_cuda(q, k, v, out, lse, do, True, 128 ** -0.5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# The bf16 backward on the tensor cores: every HEAD_DIM instantiation
# (16: d = 8, 12, 16; 32; 64; 128), ragged t and tk, t != tk either way,
# GQA with hkv = 1, 2 and 8, and the operands the host makes fit before
# the launch (d = 12 zero-padded to 16, a zero-stride or transposed dO
# copied).
MMA_CASES = [  # b, h, hkv, t, tk, d, causal, packed, dO layout, made fit
    (1, 2, 1, 100, 100, 8, True, False, "as_q", False),
    (1, 2, 2, 70, 40, 12, True, False, "as_q", True),
    (2, 4, 2, 130, 130, 16, True, True, "as_q", False),
    (1, 8, 8, 65, 200, 32, False, False, "as_q", False),
    (1, 4, 4, 200, 70, 32, True, False, "as_q", False),
    (1, 8, 1, 127, 127, 64, True, True, "as_q", False),
    (2, 8, 8, 192, 192, 128, True, True, "as_q", False),
    (1, 16, 2, 96, 160, 128, True, False, "as_q", False),
    (1, 4, 2, 96, 96, 128, True, True, "expanded", True),
    (1, 4, 2, 96, 96, 64, True, False, "transposed", True),
    (1, 8, 2, 64, 64, 128, False, True, "transposed", True)]


def _do_layout(do, layout):
    """dO as autograd may hand it over: as made, a zero-stride expand of
    one value (the grad of ``out.sum()``), or a transposed view."""
    if layout == "expanded":
        return do[:1, :1, :1, :1].reshape(()).expand(do.shape)
    if layout == "transposed":
        return do.transpose(-1, -2).contiguous().transpose(-1, -2)
    return do


@pytest.mark.parametrize(
    "b,h,hkv,t,tk,d,causal,packed,layout,made_fit", MMA_CASES)
def test_flash_backward_mma_vs_plain(gen, b, h, hkv, t, tk, d, causal,
                                     packed, layout, made_fit):
    q, k, v, do = _flash_inputs(gen, b, h, hkv, t, tk, d, torch.bfloat16,
                                packed)
    do = _do_layout(do, layout)
    assert all(attn._vec_ok(x) for x in (q, k, v, do)) is not made_fit
    scale = d ** -0.5
    out, lse = attn._flash_fwd_cuda(q, k, v, causal, scale)
    dq, dk, dv = attn._flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)
    ref_dq, dsum = attn._flash_bwd_dq_plain(q, k, v, out, do, lse, causal,
                                            scale)
    ref_dk, ref_dv = attn._flash_bwd_dkv_plain(q, k, v, do, lse, dsum,
                                               causal, scale)
    torch.cuda.synchronize()
    for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                           ("dv", dv, ref_dv)):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        err = float((got.float() - ref.float()).abs().max())
        assert err <= _tol(ref, torch.bfloat16), (name, err)


def test_flash_attention_dq_is_deterministic(gen):
    q, k, v, do = _flash_inputs(gen, 2, 8, 2, 300, 300, 64, torch.bfloat16,
                                False)
    out, lse = attn._flash_fwd_cuda(q, k, v, True, 64 ** -0.5)
    runs = [attn._flash_bwd_cuda(q, k, v, out, lse, do, True, 64 ** -0.5)[0]
            for _ in range(3)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


_PROFILER_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]


@functools.cache
def _warm_cupti() -> None:
    """One throwaway profiled launch per process before any counted
    window: a fresh process's first profiler session can deliver no
    device record at all (seen on the H100 machine), so no counted window
    may be the first."""
    with torch.profiler.profile(activities=_PROFILER_ACTIVITIES):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def _device_kernel_counts(fn, windows: int = 3):
    """Device kernel name → launches while ``fn`` runs, from the
    profiler. A window that traced no device event at all (``fn`` always
    launches kernels, so the trace was lost, not empty; seen on the H100
    machine in windows that were not a process's first) is profiled
    again, up to ``windows`` times, each retry reported as a warning."""
    _warm_cupti()
    for window in range(1, windows + 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=_PROFILER_ACTIVITIES) as prof:
            fn()
            torch.cuda.synchronize()
            # CUPTI hands the kernel records over asynchronously; a window
            # this short can lose some or all of them when the profiler
            # stops at once (seen on the H100 machine), so give it time to
            # deliver.
            time.sleep(0.1)
        counts = {e.key: e.count for e in prof.key_averages()
                  if getattr(e, "device_type", None)
                  == torch.autograd.DeviceType.CUDA}
        if counts:
            return counts
        warnings.warn(f"profiler window {window} of {windows} traced no "
                      f"device event")
    return counts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_runs_the_tensor_core_kernels_in_bf16(gen, dtype):
    """A bf16 backward through the public entry launches the two mma
    kernels (the d = 128 instantiation for packed d = 128) and no CUDA-core
    backward kernel; f32 launches the CUDA-core ones and no mma kernel."""
    q, k, v, do = (x.transpose(1, 2).reshape(2, 128, -1) for x in
                   _flash_inputs(gen, 2, 4, 2, 128, 128, 128, dtype, True))
    qp, kp, vp = (x.detach().requires_grad_() for x in (q, k, v))
    counts = _device_kernel_counts(
        lambda: attn.flash_attention_packed(qp, kp, vp, 4).backward(do))
    names = " ".join(counts)
    mma = ("flash_bwd_dq_mma_kernel<128>", "flash_bwd_dkv_mma_kernel<128>")
    cores = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    want, never = (mma, cores) if dtype == torch.bfloat16 else (cores, mma)
    for name in want:
        assert sum(n for key, n in counts.items() if name in key) == 1, \
            (name, counts)
    for name in never:
        assert name.split("<")[0] not in names, (name, counts)


def test_flash_backward_launcher_refuses_a_layout_it_cannot_copy(gen):
    """The bf16 launcher returns an error, not a misaligned 16-byte copy,
    when handed an operand the wrapper would have made fit (here a
    transposed dO), and the wrapper raises it."""
    q, k, v, do = _flash_inputs(gen, 1, 4, 2, 64, 64, 64, torch.bfloat16,
                                False)
    out, lse = attn._flash_fwd_cuda(q, k, v, True, 0.125)
    do = _do_layout(do, "transposed")
    dq = torch.empty_like(q)
    dsum = torch.empty(lse.shape, dtype=torch.float32, device="cuda")
    with pytest.raises(RuntimeError, match="flash_attention_bwd_dq kernel "
                       "launch failed"):
        attn._launch(attn._attn_lib(), "flash_attention_bwd_dq_launch",
                     "flash_attention_bwd_dq",
                     (1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                      dq.data_ptr(), dsum.data_ptr()),
                     attn._dims(q, k, True, 0.125), (q, k, v, out, do, dq))


# The bf16 forward on the tensor cores: every HEAD_DIM instantiation
# (16: d = 8, 12, 16; 32; 64; 128), MHA and GQA (hkv = 1, 2), causal
# ragged t = 1000 in both layouts, and non-causal t != tk either way.
FWD_CASES = [  # b, h, hkv, t, tk, d, causal, packed
    (1, 2, 1, 100, 100, 8, True, False),
    (1, 2, 2, 70, 40, 12, True, False),
    (2, 4, 2, 130, 130, 16, True, True),
    (1, 8, 8, 65, 200, 32, False, False),
    (1, 4, 4, 200, 70, 32, False, False),
    (1, 8, 1, 127, 127, 64, True, True),
    (1, 4, 4, 517, 300, 64, False, False),
    (2, 4, 4, 1000, 1000, 128, True, True),
    (1, 8, 2, 1000, 1000, 128, True, False),
    (1, 4, 2, 300, 517, 128, False, True)]


@pytest.mark.parametrize("b,h,hkv,t,tk,d,causal,packed", FWD_CASES)
def test_flash_forward_mma_vs_plain(gen, b, h, hkv, t, tk, d, causal,
                                    packed):
    """O within one bf16 ulp of its scale and LSE within 1e-5 of its
    scale of the plain version; O in q's layout, LSE contiguous f32."""
    q, k, v, _ = _flash_inputs(gen, b, h, hkv, t, tk, d, torch.bfloat16,
                               packed)
    scale = d ** -0.5
    n0 = LAUNCHES["flash_attention_fwd"]
    out, lse = attn._flash_fwd_cuda(q, k, v, causal, scale)
    assert LAUNCHES["flash_attention_fwd"] == n0 + 1
    ref_o, ref_lse = attn._flash_fwd_plain(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.stride() == q.stride()
    assert lse.shape == (b, h, t) and lse.dtype == torch.float32
    assert lse.is_contiguous()
    err = float((out.float() - ref_o.float()).abs().max())
    assert err <= _tol(ref_o, torch.bfloat16), err
    lse_err = float((lse - ref_lse).abs().max())
    assert lse_err <= 1e-5 * max(1.0, float(ref_lse.abs().max())), lse_err


def test_flash_forward_is_deterministic(gen):
    q, k, v, _ = _flash_inputs(gen, 2, 8, 2, 300, 300, 128, torch.bfloat16,
                               True)
    a = attn._flash_fwd_cuda(q, k, v, True, 128 ** -0.5)
    b = attn._flash_fwd_cuda(q, k, v, True, 128 ** -0.5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_forward_runs_the_tensor_core_kernel_in_bf16(gen, dtype):
    """A bf16 forward through the public entry launches the tensor-core
    forward (its HEAD_DIM 128 instantiation for packed d = 128) and no
    CUDA-core forward; f32 launches the CUDA-core one and no mma kernel."""
    q, k, v, _ = (x.transpose(1, 2).reshape(2, 128, -1) for x in
                  _flash_inputs(gen, 2, 4, 2, 128, 128, 128, dtype, True))
    counts = _device_kernel_counts(
        lambda: attn.flash_attention_packed(q, k, v, 4))
    names = " ".join(counts)
    mma, core = "flash_fwd_mma_kernel<128>", "flash_fwd_kernel"
    want, never = (mma, core) if dtype == torch.bfloat16 else (core, mma)
    assert sum(n for key, n in counts.items() if want in key) == 1, counts
    assert never.split("<")[0] not in names, counts


@pytest.mark.parametrize("operand", ["q", "o"])
def test_flash_forward_launcher_refuses_a_layout_it_cannot_copy(gen,
                                                                operand):
    """The bf16 forward launcher returns an error, not a misaligned
    16-byte copy or store, when q or O breaks the 16-byte row rule (here
    a transposed view), and the wrapper raises it."""
    q, k, v, _ = _flash_inputs(gen, 1, 4, 2, 64, 64, 64, torch.bfloat16,
                               False)
    out = torch.empty_like(q)
    lse = torch.empty((1, 4, 64), dtype=torch.float32, device="cuda")
    if operand == "q":
        q = _do_layout(q, "transposed")
    else:
        out = _do_layout(out, "transposed")
    with pytest.raises(RuntimeError, match="flash_attention_fwd kernel "
                       "launch failed"):
        attn._launch(attn._attn_lib(), "flash_attention_fwd_launch",
                     "flash_attention_fwd",
                     (1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr()),
                     attn._dims(q, k, True, 0.125), (q, k, v, out))


def test_flash_attention_autograd_on_the_card(gen):
    """The public entry on CUDA tensors goes through the kernels, forward
    and backward, and never through the plain version."""
    q, k, v, do = _flash_inputs(gen, 1, 4, 2, 64, 64, 128, torch.float32,
                                True)
    qp, kp, vp = (x.transpose(1, 2).reshape(1, 64, -1).detach()
                  .requires_grad_() for x in (q, k, v))
    n0 = dict(LAUNCHES)
    out = attn.flash_attention_packed(qp, kp, vp, 4)
    out.backward(do.transpose(1, 2).reshape(1, 64, -1))
    assert LAUNCHES["flash_attention_fwd"] == n0["flash_attention_fwd"] + 1
    assert LAUNCHES["flash_attention_bwd_dkv"] == \
        n0["flash_attention_bwd_dkv"] + 1
    assert qp.grad.shape == qp.shape and kp.grad.shape == kp.shape


def test_flash_attention_kernel_rejects_off_shapes(gen):
    q = torch.zeros((1, 2, 16, 256), device="cuda")
    with pytest.raises(ValueError, match="up to 128"):
        attn.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 16, 16), dtype=torch.float16, device="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attn.flash_attention(q, q, q)


def test_adamw_on_the_card_matches_the_cpu(gen):
    """Three updates on the card against the CPU (which
    tests/test_torch_train.py holds against optax), to 1e-6 of each
    leaf's scale: not bitwise, because PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal."""
    from tony_tpu_torch.train import adamw

    shapes = [(64, 32), (1000,)]
    params = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    cpu = [p.cpu() for p in params]
    tx = adamw(1e-2, weight_decay=0.1)
    s_gpu, s_cpu = tx.init(params), tx.init(cpu)
    for _ in range(3):
        grads = [torch.randn(s, generator=gen, device="cuda") * 1e-3
                 for s in shapes]
        s_gpu = tx.update(grads, s_gpu, params)
        s_cpu = tx.update([g.cpu() for g in grads], s_cpu, cpu)
    for a, b in zip(params + s_gpu.mu + s_gpu.nu, cpu + s_cpu.mu + s_cpu.nu):
        assert float((a.cpu() - b).abs().max()) <= 1e-6 * float(
            b.abs().max())


def test_train_step_on_the_card_matches_the_cpu(gen):
    """A tiny decoder on the packed route (head_dim 128, GQA), f32: one
    step's loss and grads on the card (kernels, cuBLAS) against the CPU
    (plain versions)."""
    from tony_tpu_torch.models import get_model
    from tony_tpu_torch.train import next_token_loss

    kw = dict(dim=256, n_heads=2, n_kv_heads=1, ffn_hidden=256,
              attention="flash", remat=True, dtype=torch.float32, seed=1)
    torch.backends.cuda.matmul.allow_tf32 = False
    models = [get_model("llama-tiny", device=d, **kw) for d in ("cpu",
                                                                "cuda")]
    models[1].load_state_dict(models[0].state_dict())   # one set of weights
    tokens = torch.randint(0, 256, (2, 200), generator=gen, device="cuda")
    n0 = LAUNCHES["flash_attention_fwd"]
    out = []
    for m in models:
        tok = tokens.to(next(m.parameters()).device)
        loss = next_token_loss(m(tok), tok)
        loss.backward()
        out.append((float(loss.detach()), {n: p.grad.cpu()
                                  for n, p in m.named_parameters()}))
    assert LAUNCHES["flash_attention_fwd"] == n0 + 2 * 2   # remat: twice
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-5)
    for name, g in out[0][1].items():
        rel = float((out[1][1][name] - g).norm() / g.norm())
        assert rel <= 1e-4, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 1000, 4099, 1 << 20])
@pytest.mark.parametrize("rule,wd", [("adamw", 0.0), ("adamw", 1e-2),
                                     ("sgd", 0.0), ("adafactor", 1e-2)])
def test_fused_bucket_update_kernel_vs_plain(gen, rule, wd, n, dtype):
    """The kernel against _rule_math on the same inputs at step 3:
    bitwise, p and every slot (both round each product, sum, quotient and
    root once, in the same order)."""
    from tony_tpu_torch.ops import fused_optim as fo

    fused = fo.FusedOptimizer(rule=rule, lr=1e-3, weight_decay=wd)
    g = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(dtype)
    p = torch.randn(n, generator=gen, device="cuda").to(dtype)
    slots = [torch.rand(n, generator=gen, device="cuda") * 1e-3
             for _ in fused.slot_names]
    scal = fused.scalars(3, "cuda")
    ref_p, ref_s = fo._rule_math(rule, g.float(), p.float(), tuple(slots),
                                 scal[0], scal[1], scal[2], **fused.hyper)
    before = LAUNCHES["fused_bucket_update"]
    out_p, out_s = fo.fused_bucket_update(g, p.clone(),
                                          [s.clone() for s in slots], scal,
                                          rule=rule, hyper=fused.hyper)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_bucket_update"] == before + 1
    assert out_p.dtype == dtype
    assert torch.equal(out_p, ref_p.to(dtype))
    for a, b in zip(out_s, ref_s):
        assert torch.equal(a, b)


def test_fused_bucket_update_kernel_rejects_off_inputs(gen):
    from tony_tpu_torch.ops import fused_optim as fo

    fused = fo.FusedOptimizer(rule="sgd")
    scal = fused.scalars(1, "cuda")
    x = torch.zeros(64, device="cuda")
    with pytest.raises(ValueError, match="both float32 or both bfloat16"):
        fo.fused_bucket_update(x.half(), x.half(), [x], scal, rule="sgd",
                               hyper=fused.hyper)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fo.fused_bucket_update(x[1:], x[1:], [x[1:]], scal, rule="sgd",
                               hyper=fused.hyper)
    with pytest.raises(ValueError, match="elements"):
        fo.fused_bucket_update(x[:32], x, [x], scal, rule="sgd",
                               hyper=fused.hyper)
    with pytest.raises(ValueError, match="scalar vector"):
        fo.fused_bucket_update(x, x, [x], scal[:3], rule="sgd",
                               hyper=fused.hyper)


def test_fused_accum_step_on_the_card_matches_the_cpu(gen):
    """Two fused accumulating steps of a tiny f32 decoder on the card
    (flash and update kernels, cuBLAS) against the CPU (plain versions):
    one update launch per bucket per step; loss to 1e-5 relative and
    parameters to 1e-5 of each leaf's scale. SGD-momentum, whose step is
    linear in the grad: AdamW's normalised step would turn the grads'
    float noise near zero into steps of up to lr."""
    from tony_tpu_torch.models import get_model
    from tony_tpu_torch.ops import FusedOptimizer
    from tony_tpu_torch.train import (create_train_state,
                                      make_accum_train_step, next_token_loss)

    kw = dict(dim=256, n_heads=2, n_kv_heads=1, ffn_hidden=256,
              attention="flash", remat=True, dtype=torch.float32, seed=1)
    torch.backends.cuda.matmul.allow_tf32 = False
    models = [get_model("llama-tiny", device=d, **kw) for d in ("cpu",
                                                                "cuda")]
    models[1].load_state_dict(models[0].state_dict())
    tokens = torch.randint(0, 256, (4, 128), generator=gen, device="cuda")
    n0 = LAUNCHES["fused_bucket_update"]
    losses = []
    for m in models:
        state = create_train_state(m, FusedOptimizer(
            rule="sgd", lr=0.1, momentum=0.9, bucket_bytes=1 << 18))
        step = make_accum_train_step(
            lambda logits, b: next_token_loss(logits, b["x"]),
            microbatches=2, update="fused_bucket")
        tok = tokens.to(next(m.parameters()).device)
        for _ in range(2):
            state, metrics = step(state, {"x": tok})
        losses.append(float(metrics["loss"]))
        state.buckets.check()
    assert LAUNCHES["fused_bucket_update"] == n0 + 2 * \
        state.buckets.plan.n_buckets
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        a, b = a.detach(), b.detach().cpu()
        assert float((b - a).abs().max()) <= 1e-5 * float(a.abs().max()), \
            name


INT8_CASES = [(1, 1, 1), (33, 70, 130), (17, 4099, 257), (64, 128, 128),
              (100, 272, 40), (256, 4096, 4096), (256, 4096, 11008),
              (512, 11008, 4096), (16, 4096, 4096), (64, 4080, 4096),
              (4096, 4112, 520), (4096, 4096, 11008)]


def _int8_case(gen, m, k, n):
    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    sx = torch.rand((), generator=gen, device="cuda")
    sw = torch.rand((n,), generator=gen, device="cuda")
    return xq, wq, sx, sw


def _int8_path(xq, wq):
    from tony_tpu_torch.ops import quant as tq

    return tq._int8_plan(xq.shape[0], wq.shape[0], xq.shape[1],
                         tq._sms(torch.cuda.current_device()),
                         xq.stride(0), wq.stride(0),
                         xq.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
                         ).path


@pytest.mark.parametrize("m,k,n", INT8_CASES)
def test_int8_matmul_kernel_vs_plain(gen, m, k, n):
    """Ragged and 7B path shapes: the kernel is bitwise its plain version
    (exact integer accumulation, the same two roundings after it)."""
    from tony_tpu_torch.ops import quant as tq

    xq, wq, sx, sw = _int8_case(gen, m, k, n)
    before = LAUNCHES["int8_matmul"]
    y = tq.int8_matmul(xq, wq, sx, sw)
    assert LAUNCHES["int8_matmul"] == before + 1
    ref = tq._int8_matmul_plain(xq, wq, sx, sw)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and torch.equal(y, ref)
    assert _int8_path(xq, wq) == ("wgmma" if k % 16 == 0 else "mma_sync")


@pytest.mark.parametrize("k", [4080, 4096, 4112])
@pytest.mark.parametrize("m", [1, 16, 64, 256, 4096])
def test_int8_matmul_forced_splits_are_bitwise(gen, m, k):
    """The wgmma path at K on both sides of a 128-byte tile's edge and a
    ragged N: every split count gives the plain version's bits, one
    launch a call however many kernels the split runs."""
    from tony_tpu_torch.ops import quant as tq

    xq, wq, sx, sw = _int8_case(gen, m, k, 264)
    assert _int8_path(xq, wq) == "wgmma"
    ref = tq._int8_matmul_plain(xq, wq, sx, sw)
    for splits in (1, 2, 3, 8):
        before = LAUNCHES["int8_matmul"]
        y = tq._int8_matmul_cuda(xq, wq, sx, sw, splits=splits)
        assert LAUNCHES["int8_matmul"] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(y, ref), splits


@pytest.mark.parametrize("tile", [(64, 128), (128, 128), (128, 176),
                                  (128, 256)])
def test_int8_matmul_every_tile_is_bitwise(gen, tile):
    """Each compiled tile of the wgmma kernel at a ragged M and N, with
    and without a split."""
    from tony_tpu_torch.ops import quant as tq

    xq, wq, sx, sw = _int8_case(gen, 300, 4112, 200)
    ref = tq._int8_matmul_plain(xq, wq, sx, sw)
    for splits in (1, 3):
        y = tq._int8_matmul_cuda(xq, wq, sx, sw, splits=splits, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(y, ref), splits


def test_int8_matmul_mma_sync_path_ignores_splits(gen):
    """Operands TMA cannot address (K = 4099) run the mma.sync kernel,
    unsplit, at any split count asked."""
    from tony_tpu_torch.ops import quant as tq

    xq, wq, sx, sw = _int8_case(gen, 64, 4099, 264)
    assert _int8_path(xq, wq) == "mma_sync"
    ref = tq._int8_matmul_plain(xq, wq, sx, sw)
    for splits in (1, 4):
        y = tq._int8_matmul_cuda(xq, wq, sx, sw, splits=splits)
        torch.cuda.synchronize()
        assert torch.equal(y, ref)


def test_int8_matmul_kernel_takes_row_strides(gen):
    """Row-strided views go through the kernels without a copy and give
    the contiguous result: 16-byte rows on the wgmma path (at every
    split count), unaligned ones on mma.sync."""
    from tony_tpu_torch.ops import quant as tq

    big = torch.randint(-127, 128, (48, 208), generator=gen, device="cuda",
                        dtype=torch.int8)
    wq = torch.randint(-127, 128, (24, 160), generator=gen, device="cuda",
                       dtype=torch.int8)
    sx, sw = torch.tensor(0.01, device="cuda"), torch.rand(24, device="cuda")
    for xq, path in ((big[:, :160], "wgmma"), (big[:, 3:163], "mma_sync")):
        assert _int8_path(xq, wq) == path
        y = tq.int8_matmul(xq, wq, sx, sw)
        assert torch.equal(y, tq.int8_matmul(xq.contiguous(), wq, sx, sw))
        assert torch.equal(y, tq._int8_matmul_plain(xq, wq, sx, sw))
        for splits in (2, 3):
            assert torch.equal(
                tq._int8_matmul_cuda(xq, wq, sx, sw, splits=splits), y)


def test_int8_matmul_kernel_rejects_off_inputs(gen):
    from tony_tpu_torch.ops import quant as tq

    x = torch.zeros((4, 32), dtype=torch.int8, device="cuda")
    sx, sw = torch.tensor(1.0, device="cuda"), torch.ones(8, device="cuda")
    with pytest.raises(ValueError, match="int8 xq and wq"):
        tq.int8_matmul(x.float(), x, sx, sw[:4])
    with pytest.raises(ValueError, match="K-contiguous"):
        tq.int8_matmul(x, torch.zeros((32, 8), dtype=torch.int8,
                                      device="cuda").t(), sx, sw)
    w8 = torch.zeros((8, 32), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="f32 scalar sx"):
        tq.int8_matmul(x, w8, sx, sw[:4])
    with pytest.raises(ValueError, match="f32 scalar sx"):
        tq.int8_matmul(x, w8, sx.double(), sw)


def test_quant_lane_never_reaches_the_plain_version(gen, monkeypatch):
    """quant_dot, its STE backward and QuantDense on CUDA tensors launch
    the kernel; the plain version is for CPU tensors only."""
    from tony_tpu_torch.ops import quant as tq

    def refuse(*a):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(tq, "_int8_matmul_plain", refuse)
    plan, paths = tq._int8_plan, []

    def recording(*args):
        out = plan(*args)
        paths.append(out.path)
        return out
    monkeypatch.setattr(tq, "_int8_plan", recording)
    x = torch.randn((3, 5, 64), generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    w = torch.randn((64, 48), generator=gen, device="cuda").requires_grad_()
    before = LAUNCHES["int8_matmul"]
    tq.quant_dot(x, w).sum().backward()
    dense = tq.QuantDense(64, 48, bias=True, device="cuda")
    dense(x.detach()).sum().backward()
    assert LAUNCHES["int8_matmul"] == before + 2
    assert paths == ["wgmma", "wgmma"]
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    assert dense.weight.grad is not None


def test_quant_train_step_kernel_vs_plain_on_the_card(gen):
    """A tiny quantized decoder on the packed flash route: one step's
    loss and every grad through the kernel and through the plain version
    on the card are equal (the integer product is exact either way)."""
    from tony_tpu_torch.models import get_model
    from tony_tpu_torch.ops import quant as tq
    from tony_tpu_torch.train import next_token_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    m = get_model("llama-tiny", device="cuda", dim=256, n_heads=2,
                  n_kv_heads=1, ffn_hidden=256, attention="flash", remat=True,
                  quant=True, seed=1)
    tok = torch.randint(0, 256, (2, 96), generator=gen, device="cuda")
    out = []
    for impl in (tq._int8_matmul_cuda, tq._int8_matmul_plain):
        saved = tq._int8_matmul_cuda
        tq._int8_matmul_cuda = impl
        try:
            m.zero_grad(set_to_none=True)
            loss = next_token_loss(m(tok), tok)
            loss.backward()
        finally:
            tq._int8_matmul_cuda = saved
        out.append((loss.detach(), [p.grad.clone() for p in m.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# Fused BatchNorm (kernel rows 10-13): (M, C) cases — ragged M, C that
# takes no 16-byte vector (3, 9), the ResNet widths.
BN_CASES = [(1, 8), (17, 3), (1000, 64), (4099, 9), (100003, 96),
            (4096, 2048), (12544, 256)]


def _bn_case(gen, m, c, dtype):
    x = (torch.randn((m, c), generator=gen, device="cuda") * 2 + 0.5).to(
        dtype)
    res = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    dy = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1.0
    beta = torch.randn(c, generator=gen, device="cuda") * 0.1
    xf = x.float()
    mean = xf.mean(0)
    var = xf.var(0, unbiased=False)
    return x, res, dy, mean, var, gamma, beta


def _sum_rel(got, ref, scale):
    """Max |got − ref| over the [2, C] sums, relative to each sum's scale
    (the sum of its terms' magnitudes, which bounds f32 summation
    error)."""
    return float(((got - ref).abs() / scale.clamp_min(1e-30)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", BN_CASES)
def test_bn_kernels_vs_plain(gen, dtype, m, c):
    """Rows 10-13 against their plain versions on the same inputs: the
    reductions within 1e-5 of their sums' scale (another summation
    order), the elementwise passes bitwise, with and without the residual
    and the ReLU; each launch counted once."""
    from tony_tpu_torch.ops import batchnorm as bn

    x, res, dy, mean, var, gamma, beta = _bn_case(gen, m, c, dtype)
    eps, minv = 1e-5, 1.0 / m
    before = dict(LAUNCHES)
    sums = bn._stats_cuda(x)
    ref = bn._stats_plain(x)
    xf = x.double()
    scale = torch.stack([xf.abs().sum(0), (xf * xf).sum(0)]).float()
    assert _sum_rel(sums, ref, scale) <= 1e-5
    for r in (None, res):
        for relu in (True, False):
            out = bn._apply_cuda(x, mean, var, gamma, beta, r, eps, relu)
            assert out.dtype == dtype and torch.equal(
                out, bn._apply_plain(x, mean, var, gamma, beta, r, eps,
                                     relu))
            red = bn._bwd_reduce_cuda(dy, x, mean, var, gamma, beta, r, eps,
                                      relu)
            red_p = bn._bwd_reduce_plain(dy, x, mean, var, gamma, beta, r,
                                         eps, relu)
            pre, xhat, _ = bn._pre_act(x, mean, var, gamma, beta, eps)
            g = bn._masked_grad(dy, pre, r, relu).double()
            scale = torch.stack([g.abs().sum(0),
                                 (g * xhat.double()).abs().sum(0)]).float()
            assert _sum_rel(red, red_p, scale) <= 1e-5
            dx, dres = bn._bwd_dx_cuda(dy, x, mean, var, gamma, beta, red_p,
                                       r, eps, relu, minv)
            dx_p, dres_p = bn._bwd_dx_plain(dy, x, mean, var, gamma, beta,
                                            red_p, r, eps, relu, minv)
            assert torch.equal(dx, dx_p)
            assert (dres is None) == (r is None)
            if r is not None:
                assert torch.equal(dres, dres_p)
    torch.cuda.synchronize()
    grew = {k: LAUNCHES[k] - before[k] for k in before
            if LAUNCHES[k] != before[k]}
    assert grew == {"bn_stats": 1, "bn_apply": 4, "bn_bwd_reduce": 2,
                    "bn_bwd_dx": 2, "bn_add_bwd_reduce": 2,
                    "bn_add_bwd_dx": 2}


def test_bn_kernels_are_deterministic(gen):
    """Two runs of every kernel are bitwise equal (no float atomics; the
    partial sums fold in a fixed order)."""
    from tony_tpu_torch.ops import batchnorm as bn

    x, res, dy, mean, var, gamma, beta = _bn_case(gen, 200003, 64,
                                                  torch.bfloat16)
    runs = []
    for _ in range(2):
        red = bn._bwd_reduce_cuda(dy, x, mean, var, gamma, beta, res, 1e-5,
                                  True)
        runs.append([bn._stats_cuda(x), red,
                     bn._apply_cuda(x, mean, var, gamma, beta, res, 1e-5,
                                    True),
                     *bn._bwd_dx_cuda(dy, x, mean, var, gamma, beta, red,
                                      res, 1e-5, True, 1 / 200003)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("with_residual", [False, True])
def test_fused_bn_act_autograd_on_the_card_matches_the_cpu(gen,
                                                           with_residual):
    """fused_bn_act forward and grads on the card (kernels) against the
    CPU (plain versions), f32, at the reference op test's tolerances."""
    from tony_tpu_torch.ops.batchnorm import fused_bn_act

    shape = (4, 8, 8, 16)
    ins = [torch.randn(shape, generator=gen, device="cuda"),
           torch.randn(16, generator=gen, device="cuda") * 0.5 + 1.0,
           torch.randn(16, generator=gen, device="cuda") * 0.1,
           torch.randn(shape, generator=gen, device="cuda")]
    wgt = torch.randn(shape, generator=gen, device="cuda")
    out = []
    for dev in ("cuda", "cpu"):
        args = [t.detach().to(dev).requires_grad_() for t in ins]
        res = args[3] if with_residual else None
        y, mean, var = fused_bn_act(args[0], args[1], args[2], res)
        (y * wgt.to(dev)).sum().backward()
        out.append([y, mean, var] + [a.grad for a in args[:3]]
                   + ([args[3].grad] if with_residual else []))
    for a, b in zip(*out):
        assert torch.allclose(a.detach().cpu(), b, atol=2e-4, rtol=2e-4)


def test_bn_kernels_reject_off_inputs(gen):
    from tony_tpu_torch.ops import batchnorm as bn

    x = torch.zeros((64, 32), device="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bn._stats_cuda(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        bn._stats_cuda(x.t())
    with pytest.raises(ValueError, match="channel vectors"):
        bn._apply_cuda(x, x[0].double(), x[0], x[0], x[0], None, 1e-5, True)
    with pytest.raises(ValueError, match="copy"):
        bn.fused_bn_act(torch.zeros((2, 32, 4, 4), device="cuda").permute(
            0, 2, 3, 1), x[0], x[0])


def test_fused_bn_act_launches_where_the_tiling_rule_declines(gen):
    """17 rows: the JAX package's tiling rule finds no tiling, so a CPU
    tensor gets None (the reference's fallback), but a CUDA tensor runs
    the kernels, which mask the ragged rows."""
    from tony_tpu_torch.ops import batchnorm as bn

    x = torch.randn((17, 64), generator=gen, device="cuda")
    gamma, beta = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    assert bn.pick_block_rows(17, 64, 4, 3) is None
    before = dict(LAUNCHES)
    out, mean, var = bn.fused_bn_act(x, gamma, beta)
    assert LAUNCHES["bn_stats"] == before["bn_stats"] + 1
    assert LAUNCHES["bn_apply"] == before["bn_apply"] + 1
    assert torch.equal(out, bn._apply_plain(x, mean, var, gamma, beta, None,
                                            1e-5, True))


@pytest.fixture()
def deterministic_cudnn():
    """f32 convolutions without TF32 and with deterministic algorithms
    for the test, the process's settings restored after."""
    flags = torch.backends.cudnn
    saved = (flags.allow_tf32, flags.deterministic, flags.benchmark)
    flags.allow_tf32, flags.deterministic, flags.benchmark = False, True, \
        False
    yield
    flags.allow_tf32, flags.deterministic, flags.benchmark = saved


def _resnet_step_card_vs_cpu(gen, batch, image):
    """One SGD step of resnet18-thin (fused lane, f32 compute) on the card
    (BN kernels, cuDNN) and on the CPU: the BN launches of the card's
    step, the two losses and the two models."""
    from tony_tpu_torch.models import get_model
    from tony_tpu_torch.train import (create_train_state, make_train_step,
                                      sgd)

    models = [get_model("resnet18-thin", device=d, fused_bn=True,
                        s2d_stem=True, dtype=torch.float32, seed=3)
              for d in ("cpu", "cuda")]
    models[1].load_state_dict(models[0].state_dict())
    x = torch.randn((batch, image, image, 3), generator=gen, device="cuda")
    y = torch.randint(0, 10, (batch,), generator=gen, device="cuda")
    before = dict(LAUNCHES)
    out = []
    for m in models:
        dev = next(m.parameters()).device
        state = create_train_state(m, sgd(0.1, momentum=0.9))
        step = make_train_step(apply_kwargs_of=lambda b: {"train": True})
        _, metrics = step(state, {"x": x.to(dev), "y": y.to(dev)})
        out.append(float(metrics["loss"]))
    grew = {k: LAUNCHES[k] - before[k] for k in before
            if LAUNCHES[k] != before[k]}
    return grew, out, models


def _assert_step_matches(losses, models):
    """The loss to 1e-4 relative, every updated parameter and running
    statistic to 1e-3 of its norm."""
    assert losses[1] == pytest.approx(losses[0], rel=1e-4)
    for (name, a), b in zip(models[0].state_dict().items(),
                            models[1].state_dict().values()):
        b = b.cpu()
        assert float((b - a).norm()) <= 1e-3 * float(a.norm()) + 1e-6, name


# One resnet18-thin step's BN launches: 9 BN layers, 2 with the residual.
RESNET18_THIN_LAUNCHES = {"bn_stats": 9, "bn_apply": 9, "bn_bwd_reduce": 7,
                          "bn_bwd_dx": 7, "bn_add_bwd_reduce": 2,
                          "bn_add_bwd_dx": 2}


def test_resnet_train_step_on_the_card_matches_the_cpu(gen,
                                                       deterministic_cudnn):
    """resnet18-thin, fused lane, f32 compute, deterministic cuDNN: one
    SGD step on the card (BN kernels, cuDNN) against the CPU (plain
    versions): the loss to 1e-4 relative, every updated parameter and
    running statistic to 1e-3 of its norm, and the launch counts of one
    step (9 BN layers, 2 with the residual)."""
    grew, out, models = _resnet_step_card_vs_cpu(gen, 8, 32)
    assert grew == RESNET18_THIN_LAUNCHES
    _assert_step_matches(out, models)


def test_resnet_runs_the_kernels_where_the_tiling_rule_declines(
        gen, deterministic_cudnn):
    """resnet18-thin at 28² and batch 2: the stem's M = 392 and stage 1's
    M = 98 are not multiples of 16, so the reference's tiling rule
    declines them (the CPU takes the plain f32 fallback there). The card
    still launches the kernels at every BN layer, and its step matches
    the CPU's as at a shape the rule accepts."""
    from tony_tpu_torch.ops import batchnorm as bn

    assert bn.pick_block_rows(392, 8, 4, 3) is None
    assert bn.pick_block_rows(98, 32, 4, 5) is None
    grew, out, models = _resnet_step_card_vs_cpu(gen, 2, 28)
    assert grew == RESNET18_THIN_LAUNCHES
    _assert_step_matches(out, models)


def test_remat_policies_recompute_the_flash_kernels_bitwise(gen):
    """llama-tiny at head_dim 128 (the packed flash route) in bf16 on the
    card, one backward under each remat policy from the same weights:
    every policy recomputes each layer's flash forward (no policy keeps
    the output of a launch the dispatcher cannot see), so each launches
    the forward twice a layer and the backward once, and the loss and
    every grad are ``torch.equal`` across policies."""
    from tony_tpu_torch.models import get_model
    from tony_tpu_torch.train import next_token_loss

    tok = torch.randint(0, 256, (2, 64), generator=gen, device="cuda")
    ref = None
    for policy in (None, "dots", "dots_no_batch"):
        m = get_model("llama-tiny", device="cuda", dim=256, n_heads=2,
                      n_kv_heads=1, ffn_hidden=256, attention="flash",
                      remat=True, remat_policy=policy, seed=1)
        before = dict(LAUNCHES)
        loss = next_token_loss(m(tok), tok)
        loss.backward()
        grew = {k: LAUNCHES[k] - before[k] for k in
                ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")}
        layers = m.cfg.n_layers
        assert grew == {"flash_attention_fwd": 2 * layers,
                        "flash_attention_bwd_dq": layers,
                        "flash_attention_bwd_dkv": layers}, policy
        got = (loss.detach(), [p.grad for p in m.parameters()])
        if ref is None:
            ref = got
            continue
        assert torch.equal(got[0], ref[0]), policy
        assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1])), policy


def test_one_rank_nccl_step_is_the_plain_step(gen):
    """The data-parallel step on a one-rank NCCL group (broadcast, one
    all_reduce per grad bucket, mean over one rank) against the step
    without a mesh from the same weights: ``torch.equal`` metrics and
    parameters after two steps."""
    import socket

    import torch.distributed as td

    from tony_tpu_torch.models import get_model
    from tony_tpu_torch.parallel import MeshSpec
    from tony_tpu_torch.train import (adamw, create_train_state,
                                      make_train_step)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    td.init_process_group("nccl", rank=0, world_size=1,
                          init_method=f"tcp://127.0.0.1:{port}")
    try:
        mesh = MeshSpec(dp=1).build()
        tok = torch.randint(0, 256, (2, 33), generator=gen, device="cuda")
        runs = []
        for m in (mesh, None):
            model = get_model("llama-tiny", device="cuda", xent_chunk=8,
                              seed=2)
            state = create_train_state(model, adamw(1e-3), mesh=m)
            step = make_train_step(
                loss_of=lambda out, b: out, mesh=m,
                apply_kwargs_of=lambda b: {"targets": b["x"]})
            metrics = [step(state, {"x": tok})[1] for _ in range(2)]
            runs.append((metrics, list(model.parameters())))
        for a, b in zip(runs[0][0], runs[1][0]):
            assert all(torch.equal(a[k], b[k]) for k in a)
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    finally:
        td.destroy_process_group()


def test_async_checkpointer_stages_on_the_card(gen, tmp_path):
    """The card path of the snapshot engine: a save stages the state into
    the device buffer, returns before the in-place step overwrites it,
    copies it into pinned host arenas on the side stream, and restores
    back onto the card bit for bit (host → device from pinned memory)."""
    from tony_tpu_torch import ckpt, profiler
    from tony_tpu_torch.models import get_model
    from tony_tpu_torch.train import (adamw, create_train_state,
                                      make_train_step, next_token_loss)

    def state(seed):
        model = get_model("llama-tiny", device="cuda", dtype=torch.float32,
                          seed=seed)
        return create_train_state(model, adamw(1e-3))

    tokens = torch.randint(0, 256, (2, 17), generator=gen, device="cuda")
    step = make_train_step(loss_of=lambda lg, b: next_token_loss(lg, b["x"]))
    live, _ = step(state(0), {"x": tokens})
    saved = {n: p.detach().clone() for n, p in live.model.named_parameters()}
    moments = [t.clone() for t in live.opt_state.mu + live.opt_state.nu]
    profiler.reset_ckpt_records()
    c = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    snap = c.save(ckpt.encode_portable(live))
    live, _ = step(live, {"x": tokens})          # overwrites in place
    c.wait()
    c.close()
    rec = profiler.ckpt_report()["async_save"]
    assert rec["stage_s"] > 0 and rec["d2h_s"] > 0 and snap.slot == 0
    got = ckpt.decode_portable(ckpt.restore_pytree(
        tmp_path, ckpt.encode_portable(state(1))))
    assert got.step == 1 and got.opt_state.count == 1
    for n, p in got.model.named_parameters():
        assert torch.equal(p, saved[n]), n
    for a, b in zip(got.opt_state.mu + got.opt_state.nu, moments):
        assert torch.equal(a, b)
    assert profiler.ckpt_report()["restore"]["h2d_s"] > 0


def test_async_checkpointer_releases_its_staging_buffer(gen, tmp_path):
    """The device staging buffer lives from a save's staging copy to the
    end of its copy-out only: after ``wait`` the card holds no second
    copy of the state, and the next save stages into a new buffer and
    reuses its pinned host slot, restoring bit for bit."""
    from tony_tpu_torch import ckpt
    from tony_tpu_torch.models import get_model
    from tony_tpu_torch.train import (adamw, create_train_state,
                                      make_train_step, next_token_loss)

    def state(seed):
        model = get_model("llama-tiny", device="cuda", dtype=torch.float32,
                          seed=seed)
        return create_train_state(model, adamw(1e-3))

    tokens = torch.randint(0, 256, (2, 17), generator=gen, device="cuda")
    step = make_train_step(loss_of=lambda lg, b: next_token_loss(lg, b["x"]))
    live, _ = step(state(0), {"x": tokens})
    c = ckpt.AsyncCheckpointer(tmp_path, keep=2, buffers=1)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        c.save(ckpt.encode_portable(live))
        c.wait()
        staged = torch.cuda.max_memory_allocated() - before
        assert c._staging.dev is None
        assert staged >= 3 * 4 * sum(p.numel()
                                     for p in live.model.parameters())
        assert torch.cuda.memory_allocated() - before < staged // 2
        host = c._staging.host[0]
        live, _ = step(live, {"x": tokens})
        saved = {n: p.detach().clone()
                 for n, p in live.model.named_parameters()}
        c.save(ckpt.encode_portable(live))
        c.wait()
        assert c._staging.dev is None and c._staging.host[0] is host
    finally:
        c.close()
    got = ckpt.decode_portable(ckpt.restore_pytree(
        tmp_path, ckpt.encode_portable(state(1))))
    assert got.step == 2
    for n, p in got.model.named_parameters():
        assert torch.equal(p, saved[n]), n


def test_device_iterator_stages_through_pinned_memory(gen):
    """On a card mesh each batch is copied from pinned memory on the
    iterator's side stream; the stream and values equal the host's."""
    import numpy as np

    from tony_tpu_torch.data import Dataset, ShardSpec
    from tony_tpu_torch.parallel import AXES, Mesh

    mesh = Mesh(shape=dict.fromkeys(AXES, 1), processes=1,
                device=torch.device("cuda", torch.cuda.current_device()))
    x = np.arange(48 * 5, dtype=np.int32).reshape(48, 5)
    ds = Dataset.from_arrays({"x": x}, seed=7).shuffle().batch(8).with_ids()
    host = list(ds.iterator(ShardSpec(0, 1)))
    with ds.device_iterator(mesh, shard=ShardSpec(0, 1)) as it:
        placed = list(it)
    assert it._side is not None
    assert len(placed) == len(host) == 6
    for a, b in zip(placed, host):
        assert a["x"].device.type == "cuda"
        assert torch.equal(a["x"].cpu(), torch.from_numpy(b["x"]))
        assert a["id"].tolist() == b["id"].tolist()


def _tiny_steps(root, seeds):
    """llama-tiny train states (f32 masters) committed at steps 1, 2, ...
    from ``seeds``, written on the CPU."""
    from tony_tpu_torch import ckpt
    from tony_tpu_torch import train as ttrain
    from tony_tpu_torch.models import get_model

    masters = []
    for step, seed in enumerate(seeds, 1):
        model = get_model("llama-tiny", device="cpu", seed=seed)
        state = ttrain.create_train_state(model, ttrain.adamw(1e-3))
        saver = ckpt.AsyncCheckpointer(root)
        saver.save(ckpt.encode_portable(state), step=step, block=True)
        saver.close()
        masters.append({n: p.detach().clone()
                        for n, p in model.named_parameters()})
    return masters


def _card_replica(root):
    from tony_tpu_torch.serve import Replica

    return Replica(model_name="llama-tiny", model_kwargs={"n_layers": 2},
                   ckpt_dir=str(root), dtype_policy="bf16", ctx_max=64,
                   block_size=8, q_block=16, max_running=4)


def _bits16(t):
    return t.detach().cpu().to(torch.bfloat16).view(torch.int16)


def test_replica_bf16_restore_on_the_card_is_bitwise(gen, tmp_path):
    """A replica on the card (``device=None``) restores the f32 masters
    through pinned memory and casts on the card: every parameter is
    bitwise the host's bf16 cast."""
    (master,) = _tiny_steps(tmp_path, [0])
    replica = _card_replica(tmp_path)
    assert replica.device.type == "cuda"
    for name, p in replica.model.named_parameters():
        assert p.device.type == "cuda"
        assert torch.equal(_bits16(p), _bits16(master[name])), name
        assert torch.equal(p.cpu(), master[name].to(torch.bfloat16)
                           .to(p.dtype)), name


def test_replica_in_place_swap_on_the_card(gen, tmp_path):
    """A hot swap on the card copies the new step into the live
    parameters: the same addresses, the new step's bits, and the tokens
    of a fresh replica on that step."""
    from tony_tpu_torch import publish

    _tiny_steps(tmp_path, [0, 7])
    publish.publish_step(tmp_path, 1)
    replica = _card_replica(tmp_path)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    replica.generate(prompt, 4)
    ptrs = {n: p.data_ptr() for n, p in replica.model.named_parameters()}
    publish.publish_step(tmp_path, 2)
    out = replica.hot_swap()
    assert out["ok"] and out["step"] == 2 and out["flip_ms"] > 0
    fresh = _card_replica(tmp_path)
    assert fresh.restored_step == 2
    got = dict(replica.model.named_parameters())
    assert {n: p.data_ptr() for n, p in got.items()} == ptrs
    for name, p in fresh.model.named_parameters():
        assert torch.equal(_bits16(got[name]), _bits16(p)), name
    assert replica.generate(prompt, 4).tokens == \
        fresh.generate(prompt, 4).tokens
