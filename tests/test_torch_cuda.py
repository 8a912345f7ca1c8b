"""Port kernels on the card: each CUDA kernel against its plain PyTorch
version at small shapes. These need an NVIDIA GPU and nvcc; without a
card they skip (decided inside the fixture, never at import). Run on
the card with::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

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
