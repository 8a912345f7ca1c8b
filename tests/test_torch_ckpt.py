"""Port parity for the checkpoint plane (tony_tpu_torch.ckpt, .publish,
.checkpoint, train_loop's checkpointing): the reference's
tests/test_ckpt.py pins (format, async saves, the multi-process commit
barrier, crash consistency, the train loop's resume) on the port's
modules; checkpoints crossing frameworks both ways on llama-tiny (JAX
writes → the port restores, the port writes → JAX restores, bit for bit,
for per-leaf AdamW and the fused optimizer's portable form); two gloo
ranks (rank 0 writes, rank 1 waits for the global commit) restored onto
one; the drain commit and the publication pointer
(tests/test_elastic.py, tests/test_publish.py); and every copied
constant equal to the reference's. Nothing is recomputed in a round trip,
so the comparisons are bitwise unless a tolerance is stated."""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tony_tpu import chaos as jchaos
from tony_tpu import ckpt as jckpt
from tony_tpu import constants as jconstants
from tony_tpu import publish as jpublish
from tony_tpu import train as jtrain
from tony_tpu.ckpt import format as jfmt
from tony_tpu.ckpt import restore as jrestore
from tony_tpu.models import get_model as jax_model
from tony_tpu.ops import fused_optim as jfo
from tony_tpu_torch import chaos, ckpt, constants, profiler, publish
from tony_tpu_torch import train as ttrain
from tony_tpu_torch.checkpoint import Checkpointer
from tony_tpu_torch.ckpt import format as fmt
from tony_tpu_torch.ckpt import restore as trestore
from tony_tpu_torch.ckpt.snapshot import (Attrs, LeafView, extract_snapshot,
                                          leaf_paths, write_snapshot)
from tony_tpu_torch.data import Dataset, ShardSpec, ckptio
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params, params_from_jax
from tony_tpu_torch.ops.fused_optim import FusedOptimizer

ROOT = Path(__file__).resolve().parent.parent
WORKLOADS = Path(__file__).parent / "workloads"
TOKENS = np.random.RandomState(0).randint(0, 256, (2, 17)).astype(np.int32)


@pytest.fixture
def clean_train_env(monkeypatch):
    for name in (constants.ENV_CKPT_DIR, constants.ENV_CKPT_EVERY,
                 constants.ENV_CKPT_KEEP, constants.ENV_PUBLISH_EVERY,
                 constants.ENV_DRAIN_FILE, constants.ENV_SERVE_STATS,
                 chaos.ENV_KILL_STEP, chaos.ENV_CRASH, fmt.ENV_CRASH):
        monkeypatch.delenv(name, raising=False)
    yield
    chaos.reset()


def _save(root, tree, step, **kw):
    c = ckpt.AsyncCheckpointer(root, **kw)
    c.save(tree, step=step, block=True)
    c.close()


def _state(seed=0, tx=None, **kw):
    model = get_model("llama-tiny", device="cpu", dtype=torch.float32,
                      seed=seed, **kw)
    return ttrain.create_train_state(
        model, ttrain.adamw(1e-3) if tx is None else tx)


def _params(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


_STEP = ttrain.make_train_step(
    loss_of=lambda logits, b: ttrain.next_token_loss(logits, b["x"]))


def _batch():
    return {"x": torch.from_numpy(TOKENS)}


class TestFormat:
    def test_commit_is_atomic_rename(self, tmp_path):
        _save(tmp_path, {"w": torch.arange(12.0).reshape(3, 4),
                         "n": torch.tensor(7, dtype=torch.int32)}, 5)
        assert fmt.committed_steps(tmp_path) == [5]
        manifest = fmt.read_manifest(tmp_path, 5)
        assert manifest["format"] == fmt.FORMAT_VERSION
        assert {m["path"] for m in manifest["leaves"]} == {"['n']", "['w']"}
        assert all("crc32" in ch for ch in manifest["chunks"])
        assert manifest["files"][0]["file"] == fmt.shard_file_name(0)
        # The reference reads the port's step.
        got = jckpt.restore_pytree(tmp_path, {"w": np.zeros((3, 4),
                                                            np.float32),
                                              "n": np.int32(0)})
        np.testing.assert_array_equal(got["w"],
                                      np.arange(12.0).reshape(3, 4))
        assert int(got["n"]) == 7

    def test_latest_step_ignores_staging_and_garbage(self, tmp_path):
        _save(tmp_path, {"w": torch.ones(2, 2)}, 1)
        (tmp_path / "step_00000002.tmp").mkdir()
        (tmp_path / "step_00000002.tmp" / "shards_00000.bin").write_bytes(
            b"torn")
        (tmp_path / "step_00000003").mkdir()
        assert ckpt.latest_step(tmp_path) == 1
        target = {"w": torch.zeros(2, 2)}
        ckpt.restore_pytree(tmp_path, target)
        assert torch.equal(target["w"], torch.ones(2, 2))

    def test_same_step_recommit_replaces_without_loss_window(self, tmp_path):
        c = ckpt.AsyncCheckpointer(tmp_path, keep=3)
        c.save({"w": torch.ones(2, 2)}, step=1, block=True)
        c.save({"w": torch.full((2, 2), 5.0)}, step=1, block=True)
        c.close()
        assert fmt.committed_steps(tmp_path) == [1]
        assert not list(Path(tmp_path).glob("*.old"))
        got = ckpt.restore_pytree(tmp_path, {"w": np.zeros((2, 2),
                                                           np.float32)})
        np.testing.assert_array_equal(got["w"], np.full((2, 2), 5.0))

    @pytest.mark.parametrize("kind", ["numpy", "tensor"])
    def test_live_leaf_snapshot_is_a_copy(self, tmp_path, kind):
        """Mutating the live array or tensor in place after save() returns
        (what the port's step does) must not leak into the committed
        bytes."""
        live = np.ones((64, 64), np.float32)
        if kind == "tensor":
            live = torch.from_numpy(live)
        c = ckpt.AsyncCheckpointer(tmp_path, keep=3)
        c.save({"w": live}, step=1)
        live[:] = -1.0
        c.wait()
        c.close()
        got = ckpt.restore_pytree(tmp_path, {"w": np.zeros((64, 64),
                                                           np.float32)})
        np.testing.assert_array_equal(got["w"], np.ones((64, 64)))

    def test_keep_prunes_old_steps(self, tmp_path):
        c = ckpt.AsyncCheckpointer(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            c.save({"w": torch.ones(2) * s}, step=s, block=True)
        c.close()
        assert fmt.committed_steps(tmp_path) == [3, 4]
        target = {"w": torch.zeros(2)}
        ckpt.restore_pytree(tmp_path, target)
        assert torch.equal(target["w"], torch.full((2,), 4.0))

    def test_keep_gc_ignores_inflight_tmp(self, tmp_path):
        c = ckpt.AsyncCheckpointer(tmp_path, keep=2)
        for s in (1, 2, 3):
            c.save({"w": torch.ones(2) * s}, step=s, block=True)
        assert fmt.committed_steps(tmp_path) == [2, 3]
        inflight = tmp_path / "step_00000005.tmp"
        inflight.mkdir()
        (inflight / fmt.shard_file_name(0)).write_bytes(b"staging")
        c.save({"w": torch.ones(2) * 4}, step=4, block=True)
        c.close()
        assert fmt.committed_steps(tmp_path) == [3, 4]
        assert (inflight / fmt.shard_file_name(0)).read_bytes() \
            == b"staging"
        assert fmt.prune(tmp_path, 1) == [3]
        assert fmt.committed_steps(tmp_path) == [4]
        assert inflight.is_dir()

    def test_corrupt_payload_raises_crc(self, tmp_path):
        _save(tmp_path, {"w": torch.ones(8, 8)}, 1)
        shard = fmt.step_dir(tmp_path, 1) / fmt.shard_file_name(0)
        raw = bytearray(shard.read_bytes())
        raw[3] ^= 0xFF
        shard.write_bytes(bytes(raw))
        with pytest.raises(IOError, match="CRC mismatch"):
            ckpt.restore_pytree(tmp_path, {"w": torch.zeros(8, 8)})
        ckpt.restore_pytree(tmp_path, {"w": torch.zeros(8, 8)},
                            verify=False)

    def test_truncated_payload_raises(self, tmp_path):
        _save(tmp_path, {"w": torch.ones(8, 8)}, 1)
        shard = fmt.step_dir(tmp_path, 1) / fmt.shard_file_name(0)
        shard.write_bytes(shard.read_bytes()[:100])
        with pytest.raises(IOError, match="truncated"):
            ckpt.restore_pytree(tmp_path, {"w": torch.zeros(8, 8)})

    def test_shape_mismatch_raises_naming_the_leaf(self, tmp_path):
        _save(tmp_path, {"w": torch.ones(4, 4)}, 1)
        with pytest.raises(ValueError, match=r"\['w'\].*different model"):
            ckpt.restore_pytree(tmp_path, {"w": torch.zeros(8, 8)})

    def test_strict_missing_leaf(self, tmp_path):
        _save(tmp_path, {"w": torch.ones(2)}, 1)
        target = {"w": torch.zeros(2), "extra": torch.full((3,), 7.0)}
        with pytest.raises(KeyError, match="extra"):
            ckpt.restore_pytree(tmp_path, target)
        got = ckpt.restore_pytree(tmp_path, target, strict=False)
        assert torch.equal(got["w"], torch.ones(2))
        assert torch.equal(got["extra"], torch.full((3,), 7.0))

    def test_bf16_roundtrip_without_ml_dtypes(self, tmp_path):
        """A port-written bfloat16 leaf is recorded as "bfloat16" and reads
        back bit for bit through its uint16 bytes; the reference reads the
        same bits through ml_dtypes, and the port reads the reference's."""
        w = (torch.arange(16, dtype=torch.float32) / 7).to(
            torch.bfloat16).reshape(4, 4)
        _save(tmp_path / "p", {"w": w}, 1)
        manifest = fmt.read_manifest(tmp_path / "p", 1)
        assert manifest["leaves"][0]["dtype"] == "bfloat16"
        target = {"w": torch.zeros(4, 4, dtype=torch.bfloat16)}
        ckpt.restore_pytree(tmp_path / "p", target)
        assert torch.equal(target["w"].view(torch.int16),
                           w.view(torch.int16))
        ref = jckpt.restore_pytree(tmp_path / "p",
                                   {"w": jnp.zeros((4, 4), jnp.bfloat16)})
        np.testing.assert_array_equal(
            np.asarray(ref["w"]).view(np.uint16),
            w.view(torch.int16).numpy().view(np.uint16))
        jw = jnp.arange(16, dtype=jnp.bfloat16).reshape(4, 4) / 3
        c = jckpt.AsyncCheckpointer(tmp_path / "j")
        c.save({"w": jw}, step=1, block=True)
        c.close()
        ckpt.restore_pytree(tmp_path / "j", target)
        np.testing.assert_array_equal(
            target["w"].view(torch.int16).numpy().view(np.uint16),
            np.asarray(jw).view(np.uint16))

    def test_spec_naming_another_axis_raises(self, tmp_path):
        _save(tmp_path, {"w": torch.ones(4, 4)}, 1)
        path = fmt.step_dir(tmp_path, 1) / fmt.MANIFEST_NAME
        manifest = fmt.read_manifest(tmp_path, 1)
        manifest["leaves"][0]["spec"] = ["data", None]
        path.write_text(__import__("json").dumps(manifest))
        ckpt.restore_pytree(tmp_path, {"w": torch.zeros(4, 4)})
        # The fsdp axis is ported (tests/test_torch_zero3.py) and so is
        # an axis of size 1 in the manifest's mesh; a tensor-parallel
        # leaf names item 11.
        manifest["leaves"][0]["spec"] = [None, "fsdp"]
        path.write_text(__import__("json").dumps(manifest))
        ckpt.restore_pytree(tmp_path, {"w": torch.zeros(4, 4)})
        manifest["leaves"][0]["spec"] = ["model", "fsdp"]
        manifest["mesh"] = {"axis_names": ["model"], "shape": {"model": 1}}
        path.write_text(__import__("json").dumps(manifest))
        ckpt.restore_pytree(tmp_path, {"w": torch.zeros(4, 4)})
        manifest["mesh"] = None
        path.write_text(__import__("json").dumps(manifest))
        with pytest.raises(NotImplementedError, match="item 11"):
            ckpt.restore_pytree(tmp_path, {"w": torch.zeros(4, 4)})

    def test_dtype_policy_matches_the_reference(self, tmp_path):
        """The serving cast: float leaves outside .opt_state assemble in
        bf16, optimizer state and integers keep their dtype — the port's
        bits equal the reference's."""
        tree = Attrs(step=torch.tensor(3, dtype=torch.int64),
                     params={"w": torch.linspace(-3, 3, 24).reshape(4, 6)},
                     opt_state={"mu": torch.linspace(0, 1, 24)})
        _save(tmp_path, tree, 1)
        port = Attrs(step=torch.tensor(0, dtype=torch.int64),
                     params={"w": torch.zeros(4, 6, dtype=torch.bfloat16)},
                     opt_state={"mu": torch.zeros(24)})
        ckpt.restore_pytree(tmp_path, port, dtype_policy="bf16")
        Ref = namedtuple("Ref", "step params opt_state")
        ref = jckpt.restore_pytree(
            tmp_path, Ref(np.int64(0), {"w": np.zeros((4, 6), np.float32)},
                          {"mu": np.zeros(24, np.float32)}),
            dtype_policy="bf16")
        assert ref.params["w"].dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            port.params["w"].view(torch.int16).numpy().view(np.uint16),
            np.asarray(ref.params["w"]).view(np.uint16))
        np.testing.assert_array_equal(port.opt_state["mu"].numpy(),
                                      ref.opt_state["mu"])
        assert int(port.step) == int(ref.step) == 3
        assert trestore.POLICY_EXEMPT_MARKERS == \
            jrestore.POLICY_EXEMPT_MARKERS
        assert trestore.DTYPE_POLICIES == jrestore.DTYPE_POLICIES
        with pytest.raises(ValueError, match="dtype_policy"):
            ckpt.restore_pytree(tmp_path, port, dtype_policy="fp8")

    def test_leaf_paths_spell_keystr(self):
        """The port's tree paths are jax.tree_util.keystr's for the same
        structure: dict keys sorted, list indices, NamedTuple fields."""
        Pair = namedtuple("Pair", "count mu")
        port = {"b": [torch.zeros(1), Pair(torch.zeros(1), {"z": 1, "a": 2})],
                "a": (torch.zeros(2),)}
        ref = {"b": [0, Pair(0, {"z": 1, "a": 2})], "a": (0,)}
        flat, _ = jax.tree_util.tree_flatten_with_path(ref)
        assert leaf_paths(port)[0] == [jax.tree_util.keystr(p)
                                       for p, _ in flat]
        view = LeafView.stacked([torch.zeros(3, 2), torch.zeros(3, 2)],
                                transpose=True)
        assert view.shape == (2, 2, 3)
        assert leaf_paths(Attrs(step=0, opt=(Attrs(count=1),)))[0] == \
            [".step", ".opt[0].count"]


class TestAsync:
    def test_async_save_snapshots_before_return(self, tmp_path):
        """save() must take its copy BEFORE returning: the port's step
        updates parameters and moments in place right after."""
        state = _state()
        state, _ = _STEP(state, _batch())
        saved = _params(state)
        c = ckpt.AsyncCheckpointer(tmp_path, keep=3)
        c.save(ckpt.encode_portable(state), step=1)
        for _ in range(3):
            state, _ = _STEP(state, _batch())
        c.wait()
        c.close()
        fresh = _state(seed=5)
        ckpt.decode_portable(ckpt.restore_pytree(
            tmp_path, ckpt.encode_portable(fresh)))
        _assert_same(_params(fresh), saved)
        assert fresh.step == 1

    def test_writer_error_surfaces_on_wait(self, tmp_path):
        c = ckpt.AsyncCheckpointer(tmp_path, keep=3)
        blocker = tmp_path / "blocker"
        blocker.write_text("not a dir")
        c.directory = blocker / "nope"
        c.save({"w": torch.ones(2)}, step=1)
        with pytest.raises(RuntimeError, match="writer failed"):
            c.wait()
        c.close()

    def test_profiler_records_stall_and_write(self, tmp_path):
        profiler.reset_ckpt_records()
        state = _state()
        c = ckpt.AsyncCheckpointer(tmp_path, keep=3)
        c.save(ckpt.encode_portable(state), step=1, block=True)
        c.close()
        rec = profiler.ckpt_report()["async_save"]
        assert rec["step"] == 1
        assert rec["nbytes"] == 3 * sum(
            p.numel() * 4 for p in state.model.parameters()) + 8 + 4
        assert rec["n_chunks"] == len(fmt.read_manifest(tmp_path,
                                                        1)["chunks"])
        assert rec["stall_s"] >= 0 and rec["write_s"] > 0
        assert {"step", "stall_s", "extract_s", "write_s", "nbytes",
                "n_chunks", "keep"} <= set(rec)
        rec["step"] = -1
        assert profiler.ckpt_report()["async_save"]["step"] == 1
        ckpt.restore_pytree(tmp_path, ckpt.encode_portable(_state(seed=2)))
        rec = profiler.ckpt_report()["restore"]
        assert rec["step"] == 1 and rec["seconds"] > 0
        assert rec["h2d_s"] == 0 and rec["h2d_nbytes"] == 0   # on the CPU
        profiler.reset_ckpt_records()
        assert profiler.ckpt_report() == {}

    def test_host_arenas_are_powers_of_two_and_hold_their_chunks(self):
        """One host slot's plan: every arena a power of two of at most 1
        GiB unless one chunk is larger, chunks 256-byte aligned, in order,
        never crossing an arena's end; a small state gets one small
        arena."""
        from tony_tpu_torch.ckpt.snapshot import plan_arenas

        mib = 1 << 20
        sizes = [524 * mib, 64 * mib, 180 * mib, 180 * mib, 3, 180 * mib,
                 1500 * mib, 16 * mib, 7]
        caps, used, place = plan_arenas(sizes)
        assert all(c & (c - 1) == 0 for c in caps)
        assert all(c <= 1 << 30 for c in caps if c != 2048 * mib)
        assert 2048 * mib in caps                      # the 1500 MiB chunk
        assert all(u <= c for u, c in zip(used, caps))
        assert [a for a, _ in place] == sorted(a for a, _ in place)
        for (a, off), n in zip(place, sizes):
            assert off % 256 == 0 and off + n <= caps[a]
        assert plan_arenas([1000, 24])[0] == [1 << 11]


class TestMultiProcessBarrier:
    def test_nonzero_process_blocks_until_global_commit(self, tmp_path):
        tree = {"w": torch.arange(8.0)}
        snap1 = extract_snapshot(tree, 1, process=1)
        assert snap1.chunks == [] and snap1.leaves    # rank 0 owns them
        done1 = threading.Event()

        def proc1():
            write_snapshot(tmp_path, snap1, process_index=1,
                           num_processes=2, barrier_timeout_s=30.0)
            done1.set()

        t = threading.Thread(target=proc1, daemon=True)
        t.start()
        time.sleep(0.3)
        assert not done1.is_set()
        assert ckpt.latest_step(tmp_path) is None
        snap0 = extract_snapshot(tree, 1, process=0)
        write_snapshot(tmp_path, snap0, process_index=0, num_processes=2,
                       barrier_timeout_s=30.0)
        assert done1.wait(timeout=30.0)
        t.join(timeout=30.0)
        assert not t.is_alive()
        assert ckpt.latest_step(tmp_path) == 1
        manifest = fmt.read_manifest(tmp_path, 1)
        assert len(manifest["files"]) == 2
        assert manifest["files"][1]["nbytes"] == 0

    def test_commit_times_out_on_missing_process(self, tmp_path):
        snap = extract_snapshot({"w": torch.ones(2)}, 1, process=0)
        with pytest.raises(TimeoutError, match="did not finish"):
            write_snapshot(tmp_path, snap, process_index=0,
                           num_processes=2, barrier_timeout_s=0.3)


class TestCrashConsistency:
    def test_sigkill_mid_save_preserves_previous_step(self, tmp_path):
        """kill -9 between the shard write and the manifest commit never
        loses the previously committed step."""
        script = textwrap.dedent("""
            import os, sys
            import numpy as np, torch
            from tony_tpu_torch import ckpt
            root, expect = sys.argv[1], sys.argv[2]
            tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
                    "s": torch.tensor(3.5)}
            c = ckpt.AsyncCheckpointer(root, keep=3)
            c.save(tree, step=1, block=True)
            np.save(expect, tree["w"].numpy())
            os.environ["TONY_CKPT_CRASH"] = "after_shards"
            c.save({"w": torch.full((8, 8), 99.0),
                    "s": torch.tensor(9.9)}, step=2, block=True)
            print("UNREACHABLE")
        """)
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        env.pop("TONY_CKPT_CRASH", None)
        root = tmp_path / "d"
        expect = tmp_path / "expect.npy"
        proc = subprocess.run(
            [sys.executable, "-c", script, str(root), str(expect)],
            env=env, capture_output=True, text=True, timeout=180)
        assert proc.returncode == -signal.SIGKILL, (proc.returncode,
                                                    proc.stdout,
                                                    proc.stderr)
        assert "UNREACHABLE" not in proc.stdout
        assert ckpt.latest_step(root) == 1
        assert (root / "step_00000002.tmp").is_dir()
        target = {"w": torch.zeros(8, 8), "s": torch.tensor(0.0)}
        ckpt.restore_pytree(root, target)
        np.testing.assert_array_equal(target["w"].numpy(), np.load(expect))
        assert float(target["s"]) == 3.5
        c = ckpt.AsyncCheckpointer(root, keep=3)
        c.close()
        assert not (root / "step_00000002.tmp").exists()
        assert ckpt.latest_step(root) == 1

    def test_crash_before_commit_rename(self, tmp_path):
        calls = []

        def hook(phase):
            calls.append(phase)
            if phase == "before_commit":
                raise KeyboardInterrupt("simulated kill")

        c = ckpt.AsyncCheckpointer(tmp_path, keep=3)
        c.save({"w": torch.ones(4)}, step=1, block=True)
        fmt.CRASH_HOOK = hook
        try:
            with pytest.raises(RuntimeError, match="writer failed"):
                c.save({"w": torch.full((4,), 2.0)}, step=2, block=True)
        finally:
            fmt.CRASH_HOOK = None
            c.close()
        assert "before_commit" in calls
        assert ckpt.latest_step(tmp_path) == 1


@pytest.mark.usefixtures("clean_train_env")
class TestTrainLoop:
    def test_plain_fold_without_ckpt_dir(self):
        final, metrics = ttrain.train_loop(_state(), _STEP, [_batch()] * 3,
                                           ckpt_dir=None)
        assert final.step == 3 and torch.isfinite(metrics["loss"])

    def test_save_every_and_resume(self, tmp_path, monkeypatch):
        """Attempt 1 trains 4 steps saving every 2 (async) through the
        TONY_CKPT_* env; attempt 2 re-enters the same loop from fresh
        weights and resumes from the newest committed step, bit for bit
        the uninterrupted run's."""
        monkeypatch.setenv(constants.ENV_CKPT_DIR, str(tmp_path / "c"))
        monkeypatch.setenv(constants.ENV_CKPT_EVERY, "2")
        monkeypatch.setenv(constants.ENV_CKPT_KEEP, "2")
        seen = []
        final, _ = ttrain.train_loop(_state(), _STEP, [_batch()] * 4,
                                     on_step=lambda i, m: seen.append(i))
        assert final.step == 4 and seen == [1, 2, 3, 4]
        assert ckpt.latest_step(tmp_path / "c") == 4
        final2, _ = ttrain.train_loop(_state(seed=1), _STEP, [_batch()] * 2)
        assert final2.step == 6 and final2.opt_state.count == 6
        assert fmt.committed_steps(tmp_path / "c") == [4, 6]
        straight, _ = ttrain.train_loop(_state(), _STEP, [_batch()] * 6,
                                        ckpt_dir="")
        _assert_same(_params(final2), _params(straight))

    def test_restore_on_start_false_ignores_checkpoint(self, tmp_path):
        ttrain.train_loop(_state(), _STEP, [_batch()] * 2,
                          ckpt_dir=str(tmp_path), save_every=1)
        final, _ = ttrain.train_loop(_state(seed=2), _STEP, [_batch()],
                                     ckpt_dir=str(tmp_path),
                                     restore_on_start=False,
                                     save_final=False)
        assert final.step == 1

    def test_unported_optimizer_state_raises(self, tmp_path):
        """AdamW's and SGD's states have checkpoint forms
        (tests/test_torch_ckpt_models.py holds SGD's); a per-leaf
        optimizer with a state of its own has none yet, and the save
        names the item that ports it."""
        def init(params):
            return {"m": [torch.zeros_like(p) for p in params]}

        tx = ttrain.GradientTransformation(init, lambda g, s, p: s)
        with pytest.raises(NotImplementedError, match="item 3"):
            ttrain.train_loop(_state(tx=tx), _STEP, [_batch()],
                              ckpt_dir=str(tmp_path))

    def test_checkpointer_shim_round_trip(self, tmp_path):
        state, _ = _STEP(_state(), _batch())
        c = Checkpointer(tmp_path / "shim")
        assert c.restore_or(_state(seed=3)).step == 0    # nothing yet
        c.save(state, step=1)
        assert c.latest_step() == 1
        fresh = c.restore_or(_state(seed=3))
        c.close()
        assert fresh.step == 1 and fresh.opt_state.count == 1
        _assert_same(_params(fresh), _params(state))


# ---------------------------------------------------------------------------
# Across frameworks
# ---------------------------------------------------------------------------

def _jax_state(tx, **kw):
    model = jax_model("llama-tiny", dtype=jnp.float32, **kw)
    return jtrain.create_train_state(model, tx, jnp.asarray(TOKENS),
                                     jax.random.PRNGKey(0))


def _jax_steps(state, n, xent=False):
    if xent:
        step = jtrain.make_train_step(
            loss_of=lambda out, b: out, donate=False,
            apply_kwargs_of=lambda b: {"targets": b["x"]})
    else:
        step = jtrain.make_train_step(
            loss_of=lambda lg, b: jtrain.next_token_loss(lg, b["x"]),
            donate=False)
    metrics = None
    for _ in range(n):
        state, metrics = step(state, {"x": jnp.asarray(TOKENS)})
    return state, metrics


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _equal_trees(a, b):
    ok = jax.tree.map(lambda x, y: np.array_equal(np.asarray(x),
                                                  np.asarray(y)), a, b)
    return all(jax.tree.leaves(ok))


def _manifest_set(root, step):
    return {(m["path"], tuple(m["shape"]), m["dtype"])
            for m in fmt.read_manifest(root, step)["leaves"]}


_LAYOUTS = {"scanned": {}, "unscanned": {"scan_layers": False},
            "xent_chunk": {"xent_chunk": 8}}


class TestAcrossFrameworks:
    def test_jax_written_step_restores_into_the_port(self, tmp_path):
        """JAX create_train_state → two optax.adamw steps → the JAX
        AsyncCheckpointer; the port restores it in place: parameters,
        mu, nu, count and step bit-equal after the layout map. One port
        step from there matches one JAX step from there within the
        tolerances tests/test_torch_train.py holds the steps to (loss and
        grad norm 1e-5 relative, parameters 2e-6 absolute)."""
        js, _ = _jax_steps(_jax_state(optax.adamw(1e-3)), 2)
        c = jckpt.AsyncCheckpointer(tmp_path)
        c.save(js, step=2, block=True)
        c.close()
        state = ckpt.decode_portable(ckpt.restore_pytree(
            tmp_path, ckpt.encode_portable(_state(seed=7))))
        assert state.step == 2 and state.opt_state.count == 2
        _assert_same(_params(state), params_from_jax(_np(js.params)))
        names = [n for n, _ in state.model.named_parameters()]
        for slot in ("mu", "nu"):
            ref = params_from_jax(_np(getattr(js.opt_state[0], slot)))
            _assert_same(dict(zip(names, getattr(state.opt_state, slot))),
                         ref)
        # load_jax_params reads the same moments, count and step.
        other = _state(seed=8)
        load_jax_params(other.model, _np(js), state=other)
        assert other.step == 2 and other.opt_state.count == 2
        _assert_same(_params(other), _params(state))
        for a, b in zip(other.opt_state.mu + other.opt_state.nu,
                        state.opt_state.mu + state.opt_state.nu):
            assert torch.equal(a, b)
        js3, jm = _jax_steps(js, 1)
        state, m = _STEP(state, _batch())
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        ref = params_from_jax(_np(js3.params))
        for name, p in state.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                       atol=2e-6, rtol=0, err_msg=name)

    @pytest.mark.parametrize("layout", sorted(_LAYOUTS))
    def test_port_written_step_restores_into_jax(self, tmp_path, layout):
        """The port trains two steps and saves; JAX restore_pytree into a
        JAX TrainState template restores every leaf equal to the port's
        tensors, and the manifest's leaf paths, shapes and dtypes are
        those of a JAX save of the same model, as sets."""
        kw = _LAYOUTS[layout]
        state = _state(**kw)
        step = _STEP
        if kw.get("xent_chunk"):
            step = ttrain.make_train_step(
                loss_of=lambda out, b: out,
                apply_kwargs_of=lambda b: {"targets": b["x"]})
        for _ in range(2):
            state, _ = step(state, _batch())
        _save(tmp_path / "p", ckpt.encode_portable(state), 2)
        tmpl = _jax_state(optax.adamw(1e-3), **kw)
        c = jckpt.AsyncCheckpointer(tmp_path / "j")
        c.save(tmpl, step=2, block=True)
        c.close()
        assert _manifest_set(tmp_path / "p", 2) == \
            _manifest_set(tmp_path / "j", 2)
        back = jckpt.restore_pytree(tmp_path / "p", tmpl)
        assert int(back.step) == 2 and int(back.opt_state[0].count) == 2
        _assert_same(params_from_jax(_np(back.params)), _params(state))
        names = [n for n, _ in state.model.named_parameters()]
        for slot in ("mu", "nu"):
            _assert_same(params_from_jax(_np(getattr(back.opt_state[0],
                                                     slot))),
                         dict(zip(names, getattr(state.opt_state, slot))))

    def test_fused_portable_form_both_ways(self, tmp_path):
        """The fused optimizer's portable form against the reference's
        codec: a JAX fused state restores into the port's buckets (by
        copy: every parameter stays a view of its bucket), and a port
        fused state restores into a JAX fused template, every leaf equal
        both ways."""
        jfused = jfo.FusedOptimizer(rule="adamw", lr=1e-3,
                                    bucket_bytes=32768)
        js = _jax_state(jfused)
        jstep = jtrain.make_accum_train_step(
            lambda lg, b: jtrain.next_token_loss(lg, b["x"]),
            jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",)),
            microbatches=2, update="fused_bucket", donate=False)
        for _ in range(2):
            js, _ = jstep(js, {"x": jnp.asarray(TOKENS)})
        c = jckpt.AsyncCheckpointer(tmp_path / "j")
        c.save(jckpt.encode_portable(js), step=2, block=True)
        c.close()
        tx = FusedOptimizer(rule="adamw", lr=1e-3, bucket_bytes=32768)
        state = _state(seed=4, tx=tx)
        before = [b.data_ptr() for b in state.opt_state["slots"]["mu"]]
        state = ckpt.decode_portable(ckpt.restore_pytree(
            tmp_path / "j", ckpt.encode_portable(state)))
        state.buckets.check()
        assert [b.data_ptr() for b in state.opt_state["slots"]["mu"]] \
            == before
        assert state.step == 2 and state.opt_state["count"] == 2
        _assert_same(_params(state), params_from_jax(_np(js.params)))
        portable = jckpt.encode_portable(js).opt_state["leaf"]
        names = [n for n, _ in state.model.named_parameters()]
        plan = state.buckets.plan
        for slot in ("mu", "nu"):
            _assert_same(dict(zip(names, plan.unpack(
                state.opt_state["slots"][slot]))),
                params_from_jax(_np(portable[slot])))
        # The other way; the manifest as a JAX save of the created state
        # (whose step is the int64 the port writes).
        _save(tmp_path / "p", ckpt.encode_portable(state), 2)
        tmpl = _jax_state(jfused)
        c = jckpt.AsyncCheckpointer(tmp_path / "t")
        c.save(jckpt.encode_portable(tmpl), step=2, block=True)
        c.close()
        assert _manifest_set(tmp_path / "p", 2) == \
            _manifest_set(tmp_path / "t", 2)
        back = jckpt.decode_portable(jckpt.restore_pytree(
            tmp_path / "p", jckpt.encode_portable(tmpl)))
        assert _equal_trees(back.params, js.params)
        assert _equal_trees(back.opt_state["slots"], js.opt_state["slots"])
        assert int(back.opt_state["count"]) == 2

    def test_fused_restore_then_step_equals_the_uninterrupted_step(
            self, tmp_path):
        """Save at step 2, restore into a fresh FusedOptimizer state,
        take one step: torch.equal to the uninterrupted step 3 in
        parameters and in every slot (a restore that rebound tensors
        instead of copying into the buckets would break this)."""
        tx = FusedOptimizer(rule="adamw", lr=1e-3, bucket_bytes=32768)
        step = ttrain.make_accum_train_step(
            lambda lg, b: ttrain.next_token_loss(lg, b["x"]),
            microbatches=2, update="fused_bucket")
        ref = _state(tx=tx)
        for _ in range(2):
            ref, _ = step(ref, _batch())
        _save(tmp_path, ckpt.encode_portable(ref), 2)
        ref, _ = step(ref, _batch())
        got = ckpt.decode_portable(ckpt.restore_pytree(
            tmp_path, ckpt.encode_portable(_state(seed=3, tx=tx))))
        got, _ = step(got, _batch())
        got.buckets.check()
        _assert_same(_params(got), _params(ref))
        for slot in ("mu", "nu"):
            for a, b in zip(got.opt_state["slots"][slot],
                            ref.opt_state["slots"][slot]):
                assert torch.equal(a, b)
        assert got.opt_state["count"] == ref.opt_state["count"] == 3

    def test_find_path_prefix_on_the_ports_saves(self, tmp_path):
        """As the reference: ".params" on a bare train state, and
        "['model'].params" on train_loop's wrapped {model, data_iter}
        payload — found by the port's and by the reference's function."""
        state = _state()
        _save(tmp_path / "bare", ckpt.encode_portable(state), 1)
        it = Dataset.from_arrays({"x": np.zeros((8, 2))}).batch(
            2).iterator(ShardSpec(0, 1))
        _save(tmp_path / "wrapped", ckptio.wrap_for_save(
            ckpt.encode_portable(state), it.state()), 1)
        params = ckpt.encode_portable(state).params
        jparams = _jax_state(optax.adamw(1e-3)).params
        for root, want in ((tmp_path / "bare", ".params"),
                           (tmp_path / "wrapped", "['model'].params")):
            assert ckpt.find_path_prefix(root, params) == want
            assert jckpt.find_path_prefix(root, jparams) == want
        served = get_model("llama-tiny", device="cpu",
                           param_dtype=torch.bfloat16, seed=9)
        from tony_tpu_torch.models.convert import jax_param_tree
        tree = jax_param_tree(served)
        ckpt.restore_pytree(tmp_path / "wrapped", tree,
                            path_prefix="['model'].params",
                            dtype_policy="bf16")
        for name, p in served.named_parameters():
            assert torch.equal(p, dict(state.model.named_parameters())[
                name].detach().to(torch.bfloat16)), name


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.usefixtures("clean_train_env")
def test_two_ranks_rank0_writes_and_one_rank_restores(tmp_path):
    """Two gloo ranks train 3 steps through train_loop(save_every=2): rank
    0 writes every chunk, rank 1 an empty shard file and waits for the
    global commit; both replicas end equal; the step restores onto one
    process (an elastic resume onto a smaller world) bit for bit."""
    port = _free_port()
    root, out = tmp_path / "ckpt", tmp_path / "params"
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKLOADS / "torch_ckpt_ranks.py"),
             str(root), str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        log, _ = p.communicate(timeout=180)
        assert p.returncode == 0, log
    assert fmt.committed_steps(root) == [2, 3]
    manifest = fmt.read_manifest(root, 3)
    assert manifest["num_processes"] == 2
    assert [f["file"] for f in manifest["files"]] == [
        fmt.shard_file_name(0), fmt.shard_file_name(1)]
    assert manifest["files"][1]["nbytes"] == 0
    assert {c["file"] for c in manifest["chunks"]} == {
        fmt.shard_file_name(0)}
    ranks = [torch.load(f"{out}.{r}.pt") for r in range(2)]
    _assert_same(ranks[0], ranks[1])
    state = ckpt.decode_portable(ckpt.restore_pytree(
        root, ckpt.encode_portable(_state(seed=6))))
    assert state.step == 3 and state.opt_state.count == 3
    _assert_same(_params(state), ranks[0])


# ---------------------------------------------------------------------------
# Drain and publication
# ---------------------------------------------------------------------------

def _commit_fake_steps(root: Path, *steps: int) -> None:
    root.mkdir(parents=True, exist_ok=True)
    for s in steps:
        d = fmt.step_dir(root, s)
        d.mkdir(exist_ok=True)
        (d / fmt.MANIFEST_NAME).write_text("{}")


class _Crashed(RuntimeError):
    """CRASH_HOOK's in-process stand-in for SIGKILL."""


@pytest.mark.usefixtures("clean_train_env")
class TestDrainAndPublish:
    def test_train_loop_drain_commits_model_and_cursor(self, tmp_path):
        """tests/test_elastic.py's pin: the drain file after step 2 →
        a SYNCHRONOUS commit of model + cursor at exactly step 2, then
        SystemExit(EXIT_DRAINED); the cursor resumes the stream."""
        ds = Dataset.from_arrays({"x": np.arange(16, dtype=np.float32)},
                                 seed=3).repeat(2).batch(4).with_ids()
        undisturbed = [b["id"].tolist() for b in ds.iterator(ShardSpec(0,
                                                                       1))]
        assert len(undisturbed) == 8
        root, drain = tmp_path / "ckpt", tmp_path / "drain"
        seen = []

        def step_fn(state, batch):
            seen.append(batch["id"].tolist())
            return state, {}

        def on_step(step, metrics):
            if step == 2:
                drain.touch()

        with pytest.raises(SystemExit) as exc:
            ttrain.train_loop({"w": np.zeros(2, np.float32)}, step_fn,
                              data=ds.iterator(ShardSpec(0, 1)),
                              ckpt_dir=str(root), on_step=on_step,
                              drain_file=str(drain))
        assert exc.value.code == constants.EXIT_DRAINED
        assert seen == undisturbed[:2]
        assert ckpt.latest_step(root) == 2
        assert ckptio.has_iter_state(root, 2)
        resumed = ds.iterator(ShardSpec(0, 1))
        resumed.restore(ckptio.load_iter_state(root, 2))
        assert [b["id"].tolist() for b in resumed] == undisturbed[2:]

    def test_publish_roundtrip_versions_and_rollback(self, tmp_path):
        _commit_fake_steps(tmp_path, 3, 7)
        rec = publish.publish_step(tmp_path)
        assert (rec["version"], rec["step"]) == (1, 7)
        assert rec["manifest"] == f"step_{7:08d}/{fmt.MANIFEST_NAME}"
        rec = publish.publish_step(tmp_path, 3, note="bad eval")
        assert (rec["version"], rec["step"], rec["note"]) == \
            (2, 3, "bad eval")
        rec = publish.publish_step(tmp_path, 3)
        assert (rec["version"], rec["step"]) == (3, 3)
        back = publish.latest_publication(tmp_path)
        assert (back["version"], back["step"]) == (3, 3)
        # The reference reads the port's pointer.
        assert jpublish.latest_publication(tmp_path)["version"] == 3

    def test_publish_uncommitted_or_empty_raises(self, tmp_path):
        with pytest.raises(publish.PublishError):
            publish.publish_step(tmp_path)
        _commit_fake_steps(tmp_path, 2)
        with pytest.raises(publish.PublishError):
            publish.publish_step(tmp_path, 5)
        (tmp_path / f"step_{9:08d}.tmp").mkdir()
        with pytest.raises(publish.PublishError):
            publish.publish_step(tmp_path, 9)

    def test_latest_publication_failure_silent(self, tmp_path):
        assert publish.latest_publication(tmp_path) is None
        (tmp_path / publish.PUBLISH_FILE).write_text("{ torn half-writ")
        assert publish.latest_publication(tmp_path) is None
        (tmp_path / publish.PUBLISH_FILE).write_text('{"version": "x"}')
        assert publish.latest_publication(tmp_path) is None

    @pytest.mark.parametrize("site", ["publish_before_stage",
                                      "publish_after_stage",
                                      "publish_after_replace"])
    def test_crash_sweep_old_or_new_never_torn(self, site, tmp_path,
                                               monkeypatch):
        _commit_fake_steps(tmp_path, 3, 7)
        old = publish.publish_step(tmp_path, 3)

        def hook(where):
            raise _Crashed(where)

        monkeypatch.setattr(chaos, "CRASH_HOOK", hook)
        monkeypatch.setenv(chaos.ENV_CRASH, site)
        with pytest.raises(_Crashed):
            publish.publish_step(tmp_path, 7)
        rec = publish.latest_publication(tmp_path)
        assert rec is not None, f"crash at {site} left a torn pointer"
        if site == "publish_after_replace":
            assert (rec["version"], rec["step"]) == (2, 7)
        else:
            assert (rec["version"], rec["step"]) == \
                (old["version"], old["step"])
        monkeypatch.delenv(chaos.ENV_CRASH)
        nxt = publish.publish_step(tmp_path, 7)
        assert nxt["version"] == rec["version"] + 1 and nxt["step"] == 7

    def test_train_loop_publishes_on_save_cadence(self, tmp_path):
        root = tmp_path / "ckpt"
        ttrain.train_loop({"w": np.zeros(2, np.float32)},
                          lambda state, batch: (state, {}), [{}] * 6,
                          ckpt_dir=str(root), save_every=2, publish_every=2)
        rec = publish.latest_publication(root)
        # Saves at 2/4/6; every 2nd save publishes (4), the final save
        # always (6): the pointer at 6, version 2.
        assert (rec["version"], rec["step"]) == (2, 6)
        assert rec["step"] in fmt.committed_steps(root)


def test_copies_equal_the_reference():
    for name in ("MANIFEST_NAME", "FORMAT_VERSION", "TMP_SUFFIX",
                 "ENV_CRASH"):
        assert getattr(fmt, name) == getattr(jfmt, name), name
    assert fmt.shard_file_name(3) == jfmt.shard_file_name(3)
    assert fmt.sidecar_name(3) == jfmt.sidecar_name(3)
    assert fmt.step_dir("r", 42) == jfmt.step_dir("r", 42)
    assert fmt.tmp_dir("r", 42) == jfmt.tmp_dir("r", 42)
    assert publish.PUBLISH_FILE == jpublish.PUBLISH_FILE
    assert chaos.ENV_CRASH == jchaos.ENV_CRASH
    assert constants.ENV_CKPT_KEEP == jconstants.ENV_CKPT_KEEP
    for name in ("float32", "int64", "int32", "uint8", "bfloat16"):
        assert fmt.dtype_name(fmt.torch_dtype(name)) == name
    assert fmt.dtype_name(torch.bfloat16) == jfmt.dtype_name(jnp.bfloat16)
