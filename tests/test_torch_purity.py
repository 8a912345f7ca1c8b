"""The port stands alone and runs on the card by default, and what it
copies from the JAX package stays equal to the original.

Import purity is checked statically (``ast``): the test process already
holds jax — other test files in the same worker, and the parity tests'
JAX side, load it — so ``sys.modules`` cannot tell whether the port
imported it. The copies held here: the job conf (every serve key, the
serve helpers, loading and the getters), the serve replica's constants, the chaos
``rpc_delay``, ``resolve_target``'s rules and the RPC wire's bytes."""

from __future__ import annotations

import ast
import json
import socket
import threading
from pathlib import Path

import pytest
import torch

from tony_tpu import chaos as jchaos
from tony_tpu import conf as jconf
from tony_tpu import constants as jconstants
from tony_tpu import publish as jpublish
from tony_tpu import rpc as jrpc
from tony_tpu.serve import swap as jswap
from tony_tpu_torch import chaos, conf, constants, publish, rpc
from tony_tpu_torch.serve import swap

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ml_dtypes", "tony_tpu"}


def _port_sources():
    files = sorted((ROOT / "tony_tpu_torch").rglob("*.py"))
    workloads = sorted((ROOT / "tests" / "workloads").glob("torch_*.py"))
    return files + [ROOT / "chip_smoke.py"] + workloads


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_sources_found():
    names = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    for must in ("tony_tpu_torch/ops/attention.py",
                 "tony_tpu_torch/models/transformer.py",
                 "tony_tpu_torch/train/__init__.py",
                 "tony_tpu_torch/serve/engine.py",
                 "tony_tpu_torch/serve/kvcache.py",
                 "tony_tpu_torch/ops/fused_optim.py",
                 "tony_tpu_torch/parallel/__init__.py",
                 "tony_tpu_torch/parallel/overlap.py", "chip_smoke.py",
                 "tony_tpu_torch/distributed.py",
                 "tony_tpu_torch/constants.py", "tony_tpu_torch/chaos.py",
                 "tony_tpu_torch/profiler.py",
                 "tony_tpu_torch/ckpt/__init__.py",
                 "tony_tpu_torch/ckpt/format.py",
                 "tony_tpu_torch/ckpt/snapshot.py",
                 "tony_tpu_torch/ckpt/restore.py",
                 "tony_tpu_torch/data/__init__.py",
                 "tony_tpu_torch/data/sharding.py",
                 "tony_tpu_torch/data/pipeline.py",
                 "tony_tpu_torch/data/ckptio.py",
                 "tony_tpu_torch/data/prefetch.py",
                 "tony_tpu_torch/publish.py",
                 "tony_tpu_torch/checkpoint.py",
                 "tony_tpu_torch/conf/__init__.py",
                 "tony_tpu_torch/rpc/__init__.py",
                 "tony_tpu_torch/serve/replica.py",
                 "tony_tpu_torch/serve/swap.py",
                 "tests/workloads/torch_dp_train.py",
                 "tests/workloads/torch_dp_steps.py",
                 "tests/workloads/torch_ckpt_ranks.py"):
        assert must in names
    from tony_tpu_torch.ops import _build
    for name in _build.SOURCES:
        assert (ROOT / f"tony_tpu_torch/ops/csrc/{name}.cu").is_file()


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_imports_nothing_of_jax_or_the_jax_package(path):
    bad = [(line, name) for line, name in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_purity_check_catches_a_jax_import(tmp_path):
    src = tmp_path / "bad.py"
    src.write_text("import numpy\nfrom tony_tpu.ops import flash_decode\n"
                   "def f():\n    import jax.numpy as jnp\n")
    roots = {name for _, name in _imported_roots(src)}
    assert {"tony_tpu", "jax"} <= roots


class TestDefaultsToTheCard:
    @pytest.fixture(autouse=True)
    def _no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_resolve_device(self):
        from tony_tpu_torch import resolve_device

        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda:0")
        assert resolve_device("cpu") == torch.device("cpu")

    def test_serve_engine_device_none_raises(self):
        from tony_tpu_torch.models import get_model
        from tony_tpu_torch.serve import ServeEngine

        model = get_model("llama-tiny", device="cpu")
        with pytest.raises(RuntimeError, match="is_available"):
            ServeEngine(model, ctx_max=64)

    def test_model_and_cache_device_none_raise(self):
        from tony_tpu_torch.models import get_model
        from tony_tpu_torch.serve import PagedKVCache

        with pytest.raises(RuntimeError, match="is_available"):
            get_model("llama-tiny")
        with pytest.raises(RuntimeError, match="is_available"):
            get_model("llama2-7b")       # raises before any allocation
        with pytest.raises(RuntimeError, match="is_available"):
            PagedKVCache(2, 8, n_blocks=4, block_size=4)

    def test_quant_dense_device_none_raises(self):
        """The int8 lane's public layer resolves ``device=None`` to the
        card like every other constructor, so without a GPU it raises
        instead of building its weight on the CPU."""
        from tony_tpu_torch.ops import QuantDense

        with pytest.raises(RuntimeError, match="is_available"):
            QuantDense(16, 8)
        assert QuantDense(16, 8, device="cpu").weight.device.type == "cpu"


# ---------------------------------------------------------------------------
# Copies equal to their originals
# ---------------------------------------------------------------------------

_JOB_TYPES = ("serve", "worker", "prefill", "chief")
_CONF_HELPERS = ("serve_role_key", "serve_warm_standby_key")


class TestCopiesEqualTheReference:
    def test_conf_keys_defaults_and_helpers(self):
        names = [n for n in vars(conf) if n.isupper()]
        for name in names:
            assert getattr(conf, name) == getattr(jconf, name), name
        serve_keys = {n for n in vars(jconf) if n.startswith("SERVE_")}
        assert set(names) == serve_keys | {"CKPT_DIR"}
        for helper in _CONF_HELPERS:
            for jt in _JOB_TYPES:
                assert getattr(conf, helper)(jt) == \
                    getattr(jconf, helper)(jt), (helper, jt)

    @pytest.mark.parametrize("suffix", [".json", ".xml"])
    def test_conf_loading_and_getters(self, tmp_path, suffix):
        """The copy reads the conf the AM serializes (``TonyConfig.save``,
        JSON, defaults included) to the same typed values as the
        original. A Hadoop-style XML file, which only the client reads,
        is refused rather than read wrongly."""
        props = {"tony.serve.instances": "2", "tony.chief.instances": "1",
                 "tony.serve.model-kwargs": '{"n_layers": 2}',
                 "tony.serve.prefix-cache": "yes", "tony.serve.spec-k": "",
                 "tony.serve.demote-watermark": "0.25",
                 "tony.worker.env": "A=1,B=2"}
        path = tmp_path / f"tony{suffix}"
        if suffix == ".xml":
            path.write_text("<configuration>" + "".join(
                f"<property><name>{k}</name><value>{v}</value></property>"
                for k, v in props.items()) + "</configuration>")
            assert jconf.TonyConfig.load(path).get(
                "tony.serve.demote-watermark") == "0.25"
            with pytest.raises(ValueError):
                conf.TonyConfig.load(path)
            return
        jconf.TonyConfig(props).save(path)
        ours, ref = conf.TonyConfig.load(path), jconf.TonyConfig.load(path)
        for key in json.loads(path.read_text()):
            assert ours.get(key) == ref.get(key), key
            assert ours.get_bool(key) == ref.get_bool(key), key
        assert ours.get("tony.serve.port", "x") == \
            ref.get("tony.serve.port", "x") == "x"
        assert ours.get_bool("tony.serve.prefix-cache") is True
        assert ours.get_bool("tony.serve.spec-k", True) is True
        assert ours.get_int("tony.serve.spec-k", 7) == \
            ref.get_int("tony.serve.spec-k", 7) == 7
        assert ours.get_int("tony.serve.instances") == 2
        assert ours.get_float("tony.serve.demote-watermark") == 0.25
        assert conf.TonyConfig(props).get("tony.chief.instances") == "1"

    def test_replica_constants(self):
        for name in ("ENV_CONF_PATH", "ENV_JOB_NAME", "ENV_SERVE_STATS",
                     "ENV_TASK_INDEX"):
            assert getattr(constants, name) == getattr(jconstants, name), \
                name

    def test_chaos_rpc_delay(self, monkeypatch):
        assert (chaos.ENV_RPC_DELAY_S, chaos.ENV_RPC_DELAY_CALLS) == \
            (jchaos.ENV_RPC_DELAY_S, jchaos.ENV_RPC_DELAY_CALLS)
        seen = {}
        for mod in (chaos, jchaos):
            mod.reset()
            slept = seen.setdefault(mod.__name__, [])
            monkeypatch.setattr(mod, "SLEEP_HOOK", slept.append)
            monkeypatch.setenv(mod.ENV_RPC_DELAY_S, "0.25")
            monkeypatch.setenv(mod.ENV_RPC_DELAY_CALLS, "2")
            for _ in range(4):
                mod.rpc_delay()
            monkeypatch.setenv(mod.ENV_RPC_DELAY_S, "soon")
            with pytest.raises(ValueError, match="not a number"):
                mod.rpc_delay()
            monkeypatch.setenv(mod.ENV_RPC_DELAY_S, "-1")
            with pytest.raises(ValueError, match=">= 0"):
                mod.rpc_delay()
            monkeypatch.delenv(mod.ENV_RPC_DELAY_S)
            mod.rpc_delay()
            mod.reset()
        assert seen["tony_tpu_torch.chaos"] == seen["tony_tpu.chaos"] == \
            [0.25, 0.25]
        assert chaos.SLEEP_HOOK is None

    def test_resolve_target_rules(self, tmp_path):
        """The same pointer and pins give the same target, or the same
        refusal, through the port's copy and the original."""
        for s in (1, 2, 3):
            d = tmp_path / f"step_{s:08d}"
            d.mkdir()
            (d / "manifest.json").write_text("{}")

        def both(**kw):
            out = []
            for fn, err in ((swap.resolve_target, swap.SwapError),
                            (jswap.resolve_target, jswap.SwapError)):
                try:
                    out.append(fn(str(tmp_path), **kw))
                except err as exc:
                    out.append(("SwapError", str(exc)))
            assert out[0] == out[1], kw
            return out[0]

        assert both()[0] == "SwapError"          # nothing published
        assert both(step=2) == (0, 2)
        assert both(step=9)[0] == "SwapError"    # not committed
        v = jpublish.publish_step(tmp_path, 2)["version"]
        assert both() == (v, 2) and both(step=2) == (v, 2)
        assert both(step=3) == (0, 3)
        w = publish.publish_step(tmp_path, 3)["version"]
        assert w == v + 1
        assert both(version=w) == (w, 3)
        assert both(version=v)[0] == "SwapError"  # the pointer moved on
        assert issubclass(swap.SwapError, RuntimeError)

    def test_rpc_wire_bytes(self):
        """A call's request line, and a server's response lines (result,
        application error, unknown verb, bad token), byte for byte the
        reference's."""
        lines = []
        listener = socket.socket()
        listener.bind(("127.0.0.1", 0))
        listener.listen(2)

        def capture():
            for _ in range(2):
                conn, _ = listener.accept()
                with conn, conn.makefile("rwb") as f:
                    lines.append(f.readline())
                    f.write(b'{"ok": true, "result": [1, 2]}\n')
                    f.flush()

        t = threading.Thread(target=capture, daemon=True)
        t.start()
        addr = f"127.0.0.1:{listener.getsockname()[1]}"
        for client in (rpc.RpcClient, jrpc.RpcClient):
            with client(addr, token="tok", timeout=10) as c:
                assert c.call("generate", tokens=[1, 2],
                              max_new_tokens=3, rid=None) == [1, 2]
        t.join(timeout=10)
        listener.close()
        assert lines[0] == lines[1] and lines[0].startswith(b'{"method"')

        class Handler:
            def rpc_echo(self, **kw):
                return kw

            def rpc_fail(self):
                raise ValueError("no")

        requests = [{"method": "echo", "params": {"a": [1, 2.5, None]},
                     "token": "tok"},
                    {"method": "fail", "token": "tok"},
                    {"method": "nope", "token": "tok"},
                    {"method": "echo", "token": "bad"}]
        replies = []
        for server_cls in (rpc.RpcServer, jrpc.RpcServer):
            server = server_cls(Handler(), host="127.0.0.1",
                                token="tok").start()
            try:
                with socket.create_connection(("127.0.0.1", server.port),
                                              timeout=10) as sock, \
                        sock.makefile("rwb") as f:
                    got = []
                    for req in requests:
                        f.write((json.dumps(req) + "\n").encode())
                        f.flush()
                        got.append(f.readline())
                    replies.append(got)
            finally:
                server.stop()
        assert replies[0] == replies[1]
        assert replies[0][1] == b'{"ok": false, "error": "ValueError: no"}\n'
