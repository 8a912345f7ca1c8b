"""The split over the cache of the port's bf16 flash-decode kernel, on
the CPU: the plain model of its fold (``_decode_chunked_plain``: each
chunk's softmax state from a fresh state, folded left in chunk order, a
chunk left out of a row by position) and the host's launch plan
(``_decode_plan``). The model gives the same bits at every split count,
agrees with the plain flash-decode and with the JAX package's
``flash_decode`` (its XLA path and its Pallas kernel in interpret mode) on
the same numpy inputs, and leaves a row's bits alone where a chunk starts
past its position. The kernel itself runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tony_tpu.ops import attention as jattn
from tony_tpu_torch.ops import attention as tattn

# The H100's blocks at once (132 SMs × the kernel's occupancy at
# HEAD_DIM 128: four one-tile blocks an SM, two four-tile blocks), so the
# plans below are the card's at the serving shapes.
H100_SLOTS = {1: 132 * 4, 4: 132 * 2}


def _inputs(seed, b, h, hkv, t, d, ctx, ragged=True):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, t, d).astype(np.float32)
    k = rng.randn(b, hkv, ctx, d).astype(np.float32)
    v = rng.randn(b, hkv, ctx, d).astype(np.float32)
    if ragged:
        # Consecutive rows from a per-sequence start, some past the cache
        # end (the decode block's padding rows).
        p0 = rng.randint(0, ctx, (b, 1))
        pos = (p0 + np.arange(t)[None]).astype(np.int32)
    else:
        pos = rng.randint(0, ctx + 8, (b, t)).astype(np.int32)
    return q, k, v, pos


def _chunked(q, k, v, pos, chunk, splits, dtype=torch.float32):
    args = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return tattn._decode_chunked_plain(*args, torch.from_numpy(pos),
                                       q.shape[-1] ** -0.5, chunk, splits)


SHAPES = [  # b, h, hkv, t, d, ctx
    (2, 4, 4, 16, 16, 300), (3, 4, 2, 16, 32, 200), (2, 8, 2, 5, 64, 100),
    (1, 4, 1, 33, 64, 40)]


class TestChunkedFold:
    @pytest.mark.parametrize("chunk", [32, 64, 256])
    @pytest.mark.parametrize("b,h,hkv,t,d,ctx", SHAPES)
    def test_same_bits_at_every_split_count(self, b, h, hkv, t, d, ctx,
                                            chunk):
        q, k, v, pos = _inputs(0, b, h, hkv, t, d, ctx, ragged=False)
        one = _chunked(q, k, v, pos, chunk, 1)
        for splits in (2, 4, 3, 64):
            assert torch.equal(_chunked(q, k, v, pos, chunk, splits), one)

    def test_same_bits_at_every_split_count_bf16(self):
        q, k, v, pos = _inputs(1, 2, 4, 2, 16, 32, 300)
        one = _chunked(q, k, v, pos, 64, 1, torch.bfloat16)
        assert one.dtype == torch.bfloat16
        for splits in (2, 4):
            assert torch.equal(
                _chunked(q, k, v, pos, 64, splits, torch.bfloat16), one)

    @pytest.mark.parametrize("chunk,splits", [(64, 1), (64, 4), (256, 2)])
    @pytest.mark.parametrize("b,h,hkv,t,d,ctx", SHAPES)
    def test_matches_plain_decode(self, b, h, hkv, t, d, ctx, chunk, splits):
        q, k, v, pos = _inputs(2, b, h, hkv, t, d, ctx)
        got = _chunked(q, k, v, pos, chunk, splits)
        ref = tattn._decode_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                  torch.from_numpy(pos), d ** -0.5, ctx)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                                   rtol=1e-5)

    @pytest.mark.parametrize("interpret", [None, True])
    @pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (4, 1)])
    def test_matches_the_jax_flash_decode(self, h, hkv, interpret):
        q, k, v, pos = _inputs(3, 3, h, hkv, 16, 16, 64)
        ref = jattn.flash_decode(
            *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(pos),
            block_k=16, interpret=interpret)
        for splits in (1, 2):
            got = _chunked(q, k, v, pos, 16, splits)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("splits", [1, 2])
    def test_a_chunk_past_the_row_changes_no_bit(self, splits):
        """Rows at positions below 256 give the same bits with the cache
        cut at 256 (one chunk) as with 300 keys (a second chunk starting
        at 256, left out of those rows by position; its keys would hold
        p = exp(0) = 1 under the finite mask if folded by value)."""
        q, k, v, _ = _inputs(4, 2, 4, 2, 16, 32, 300)
        pos = np.array([np.arange(240, 256), np.arange(100, 116)],
                       np.int32)
        whole = _chunked(q, k, v, pos, 256, splits)
        cut = _chunked(q, k[:, :, :256], v[:, :, :256], pos, 256, splits)
        assert torch.equal(whole, cut)
        pos[0, -1] = 256          # this row now admits key 256
        assert not torch.equal(_chunked(q, k, v, pos, 256, splits)[0, :, -1],
                               whole[0, :, -1])

    def test_a_row_with_a_negative_position_is_zero(self):
        q, k, v, pos = _inputs(5, 1, 2, 2, 4, 16, 100, ragged=False)
        pos[0, 1] = -1
        out = _chunked(q, k, v, pos, 32, 2)
        assert torch.equal(out[0, :, 1], torch.zeros_like(out[0, :, 1]))
        assert bool(out[0, :, 0].abs().sum() > 0)

    def test_merge_with_a_fresh_state_is_exact(self):
        rng = np.random.RandomState(6)
        mc = torch.from_numpy(rng.randn(3, 1).astype(np.float32))
        lc = torch.from_numpy(rng.rand(3, 1).astype(np.float32) * 50)
        accc = torch.from_numpy(rng.randn(3, 8).astype(np.float32))
        fresh = (torch.full((3, 1), tattn._NEG_INF), torch.zeros(3, 1),
                 torch.zeros(3, 8))
        m, l, acc = tattn._merge_state(*fresh, mc, lc, accc,
                                       torch.ones(3, 1, dtype=torch.bool))
        assert torch.equal(m, mc) and torch.equal(l, lc) \
            and torch.equal(acc, accc)


class TestPlan:
    @pytest.mark.parametrize("b,hkv,t,want", [
        (16, 32, 16, tattn.DecodePlan(1, 1, 8, None)),          # decode
        (4, 32, 16, tattn.DecodePlan(1, 8, 1, (2048, 8, 130))),  # b=4
        (1, 32, 16, tattn.DecodePlan(1, 8, 1, (512, 8, 130))),   # b=1
        (16, 8, 16, tattn.DecodePlan(4, 4, 2, (8192, 8, 130))),  # GQA
        (1, 32, 512, tattn.DecodePlan(4, 1, 8, None)),           # prefill
    ])
    def test_the_serving_shapes(self, b, hkv, t, want):
        plan = tattn._decode_plan(b, 32, hkv, t, 128, 2048,
                                  H100_SLOTS.__getitem__)
        assert plan == want

    @pytest.mark.parametrize("b,h,hkv,t,d,ctx", [
        (1, 4, 4, 16, 64, 40), (3, 8, 2, 33, 256, 700), (2, 2, 1, 5, 8, 17),
        (1, 32, 32, 16, 128, 5000), (700, 1, 1, 1, 8, 70000)])
    @pytest.mark.parametrize("splits", [None, 1, 2, 3, 10 ** 6])
    def test_every_chunk_in_exactly_one_range(self, b, h, hkv, t, d, ctx,
                                              splits):
        plan = tattn._decode_plan(b, h, hkv, t, d, ctx, lambda rt: 264,
                                  splits)
        n_chunks = -(-ctx // tattn._DECODE_CHUNK)
        assert plan.rt == (1 if (h // hkv) * t <= 16 else 4)
        assert plan.splits * plan.cps >= n_chunks
        assert (plan.splits - 1) * plan.cps < n_chunks
        assert 1 <= plan.splits <= max(1, 65535 // b)
        if splits is not None:
            assert plan.splits <= max(1, splits)
        assert plan.workspace == (
            None if plan.splits == 1
            else (b * h * t, n_chunks, d + 2))


def test_cpu_tensors_run_the_plain_version():
    """On the CPU, flash_decode is the plain version, block by block as
    the JAX package's XLA path (the chunked model is the kernel's, on the
    card only)."""
    q, k, v, pos = _inputs(7, 2, 4, 2, 16, 16, 64)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    got = tattn.flash_decode(*args, torch.from_numpy(pos), block_k=16)
    ref = tattn._decode_plain(*args, torch.from_numpy(pos), 16 ** -0.5, 16)
    assert torch.equal(got, ref)
