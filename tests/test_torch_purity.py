"""The port stands alone and runs on the card by default, and what it
copies from the JAX package stays equal to the original.

Import purity is checked statically (``ast``): the test process already
holds jax — other test files in the same worker, and the parity tests'
JAX side, load it — so ``sys.modules`` cannot tell whether the port
imported it. The control plane (``conf``, ``constants``, ``util``,
``discovery``, ``session``, ``rpc``, ``events``, ``chaos``, ``runtime/``,
``scheduler``, ``executor``, ``am``, ``client``, ``cli``, ``minipod``)
imports only the standard library and its own modules, and importing the
package imports nothing else. The copies held here: the job conf (every
shared key, default and helper, loading and the getters), the
constants, the chaos names and ``rpc_delay``, ``resolve_target``'s rules,
the RPC wire's bytes, the AOT cache's constants, format tag and
``fingerprint_key``, and the event names and reader."""

from __future__ import annotations

import ast
import json
import socket
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from tony_tpu import chaos as jchaos
from tony_tpu import conf as jconf
from tony_tpu import constants as jconstants
from tony_tpu import events as jevents
from tony_tpu import publish as jpublish
from tony_tpu import rpc as jrpc
from tony_tpu.ckpt import aot as jaot
from tony_tpu.serve import swap as jswap
from tony_tpu_torch import chaos, conf, constants, events, publish, rpc
from tony_tpu_torch.ckpt import aot
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
                 "tony_tpu_torch/serve/prefix.py",
                 "tony_tpu_torch/serve/spec.py",
                 "tony_tpu_torch/ops/fused_optim.py",
                 "tony_tpu_torch/parallel/__init__.py",
                 "tony_tpu_torch/parallel/overlap.py",
                 "tony_tpu_torch/parallel/sched.py",
                 "tony_tpu_torch/parallel/layout.py", "chip_smoke.py",
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
                 "tony_tpu_torch/serve/router.py",
                 "tony_tpu_torch/serve/disagg.py",
                 "tony_tpu_torch/ckpt/aot.py",
                 "tony_tpu_torch/events/__init__.py",
                 "tests/workloads/torch_dp_train.py",
                 "tests/workloads/torch_dp_steps.py",
                 "tests/workloads/torch_ckpt_ranks.py",
                 "tests/workloads/torch_zero3_steps.py",
                 "tests/workloads/torch_zero3_train.py",
                 "tests/workloads/torch_train_resume.py",
                 "tests/workloads/torch_job_train.py",
                 *(f"tony_tpu_torch/{m}" for m in CONTROL_PLANE)):
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


# The port's control plane: standard library and each other only (the
# executor and AM start as ``python -S``).
CONTROL_PLANE = ("__init__.py", "conf/__init__.py", "constants.py",
                 "util.py", "discovery.py", "ckpt_layout.py", "session.py",
                 "rpc/__init__.py",
                 "events/__init__.py", "chaos.py", "runtime/__init__.py",
                 "runtime/base.py", "runtime/standalone.py",
                 "runtime/pytorch_runtime.py", "scheduler/__init__.py",
                 "executor/__init__.py", "executor/__main__.py",
                 "am/__init__.py", "am/__main__.py", "client.py",
                 "cli/__init__.py", "cli/__main__.py",
                 "minipod/__init__.py")
_CONTROL_MODULES = {"tony_tpu_torch." + m[:-3].replace("/", ".")
                    .removesuffix(".__init__") for m in CONTROL_PLANE}


def _module_level_imports(path: Path):
    """Absolute module names imported at module level (not inside a
    function, and not under ``if TYPE_CHECKING``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []

    def visit(nodes):
        for node in nodes:
            if isinstance(node, ast.Import):
                out.extend(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                out.extend(f"{node.module}.{a.name}"
                           if node.module == "tony_tpu_torch"
                           else node.module for a in node.names)
            elif isinstance(node, ast.If) and not (
                    isinstance(node.test, ast.Name)
                    and node.test.id == "TYPE_CHECKING"):
                visit(node.body + node.orelse)
            elif isinstance(node, (ast.Try,)):
                visit(node.body + node.orelse + node.finalbody)
    visit(tree.body)
    return out


@pytest.mark.parametrize("name", CONTROL_PLANE)
def test_control_plane_imports_only_the_stdlib(name):
    for mod in _module_level_imports(ROOT / "tony_tpu_torch" / name):
        root = mod.split(".")[0]
        if root == "tony_tpu_torch":
            assert mod in _CONTROL_MODULES | {"tony_tpu_torch"}, \
                f"{name} imports {mod}"
        else:
            assert root in sys.stdlib_module_names, f"{name} imports {mod}"


# Serving modules that run on a gateway host with no tensor library:
# the request router, the handoff module whose error type it imports,
# the chain keys, and the package's lazy facade (standard library, numpy
# and each other).
TENSOR_FREE = ("serve/__init__.py", "serve/router.py", "serve/disagg.py",
               "serve/prefix.py", "serve/kvstore.py", "serve/qos.py")


@pytest.mark.parametrize("name", TENSOR_FREE)
def test_tensor_free_serving_modules(name):
    """Neither torch nor jax, at module level or inside a function."""
    roots = {root for _, root in
             _imported_roots(ROOT / "tony_tpu_torch" / name)}
    assert not roots & ({"torch", "triton"} | FORBIDDEN), name
    for mod in _module_level_imports(ROOT / "tony_tpu_torch" / name):
        root = mod.split(".")[0]
        assert root in sys.stdlib_module_names | {"numpy",
                                                   "tony_tpu_torch"}, mod
        if root == "tony_tpu_torch":
            assert mod in {"tony_tpu_torch.serve",
                           "tony_tpu_torch.serve.prefix",
                           "tony_tpu_torch.serve.disagg",
                           "tony_tpu_torch.ckpt_layout"}, mod


def test_executor_starts_without_site():
    """``python -S`` (the executor's and the AM's interpreter flags)
    imports the executor, the AM and the CLI with nothing but the
    standard library and the port's control plane."""
    code = ("import sys; import tony_tpu_torch.executor, tony_tpu_torch.am, "
            "tony_tpu_torch.cli, tony_tpu_torch.client, "
            "tony_tpu_torch.minipod; print(sorted({m.split('.')[0] for m "
            "in sys.modules} - set(sys.stdlib_module_names) "
            "- {'__main__'}))")
    out = subprocess.run([sys.executable, "-S", "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60,
                         env={"PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["['tony_tpu_torch']"]


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
_CONF_HELPERS = ("serve_role_key", "serve_warm_standby_key",
                 "instances_key")


class TestCopiesEqualTheReference:
    def test_conf_keys_defaults_and_helpers(self):
        """Every key both confs name is the same string; the port leaves
        out the JAX runtime's libtpu, multi-slice and XLA keys and the
        chip census override, and adds the GPU census and host keys; the
        defaults differ only in the framework; the helpers agree."""
        ours = {n for n in vars(conf) if n.isupper()}
        ref = {n for n in vars(jconf) if n.isupper()}
        for name in ours & ref - {"DEFAULTS"}:
            assert getattr(conf, name) == getattr(jconf, name), name
        assert ref - ours == {"JAX_OVERLAP_XLA_FLAGS", "JAX_SLICES",
                              "LIBTPU_PORT_BASE", "MEGASCALE_PORT",
                              "SCHEDULER_TOTAL_TPUS"}
        assert ours - ref == {"SCHEDULER_BACKEND", "SCHEDULER_HOST_GPUS",
                              "SCHEDULER_TOTAL_GPUS"}
        diff = {k for k in conf.DEFAULTS.keys() | jconf.DEFAULTS.keys()
                if conf.DEFAULTS.get(k) != jconf.DEFAULTS.get(k)}
        assert diff == {conf.APPLICATION_FRAMEWORK}
        assert conf.DEFAULTS[conf.APPLICATION_FRAMEWORK] == "pytorch"
        for helper in _CONF_HELPERS:
            for jt in _JOB_TYPES:
                assert getattr(conf, helper)(jt) == \
                    getattr(jconf, helper)(jt), (helper, jt)

    @pytest.mark.parametrize("suffix", [".json", ".xml"])
    def test_conf_loading_and_getters(self, tmp_path, suffix):
        """The copy reads the conf the AM serializes (``TonyConfig.save``,
        JSON, defaults included) and a Hadoop-style ``tony.xml`` to the
        same typed values as the original."""
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
        else:
            jconf.TonyConfig(props).save(path)
        ours, ref = conf.TonyConfig.load(path), jconf.TonyConfig.load(path)
        for key in props.keys() | (set(json.loads(path.read_text()))
                                   if suffix == ".json" else set()):
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
        for jt in _JOB_TYPES:
            assert ours.instances(jt) == ref.instances(jt), jt

    def test_replica_constants(self):
        for name in ("ENV_CONF_PATH", "ENV_JOB_NAME", "ENV_SERVE_STATS",
                     "ENV_TASK_INDEX", "ENV_TRAIN_AOT_CACHE",
                     "EVENTS_DIR_INTERMEDIATE", "EVENTS_DIR_FINISHED",
                     "JHIST_SUFFIX", "JHIST_INPROGRESS_SUFFIX"):
            assert getattr(constants, name) == getattr(jconstants, name), \
                name

    def test_constants_chaos_and_event_names(self, monkeypatch):
        """Every constant both packages name is equal, and the port adds
        only its CUDA seams; the chaos env names and the executor's
        heartbeat drop schedule, and the event names, are the
        reference's."""
        ours = {n for n in vars(constants) if n.isupper()}
        ref = {n for n in vars(jconstants) if n.isupper()}
        for name in ours & ref:
            assert getattr(constants, name) == getattr(jconstants, name), \
                name
        assert ours - ref == {"ENV_CUDA_VISIBLE_DEVICES",
                              "ENV_CUDA_DEVICE_ORDER", "ENV_TASK_GPUS",
                              "ENV_NCCL_ASYNC_ERROR_HANDLING"}
        assert {n for n in vars(chaos) if n.startswith("ENV_")} == \
            {n for n in vars(jchaos) if n.startswith("ENV_")}
        for name in (n for n in vars(jchaos) if n.startswith("ENV_")):
            assert getattr(chaos, name) == getattr(jchaos, name), name
        for mod in (chaos, jchaos):
            mod.reset()
            monkeypatch.setenv(mod.ENV_HB_DROP, "2")
            assert [mod.drop_heartbeat() for _ in range(4)] == \
                [True, True, False, False], mod.__name__
            mod.reset()
        names = {n for n in vars(jevents) if n.isupper()
                 and isinstance(getattr(jevents, n), str)}
        for name in names:
            assert getattr(events, name) == getattr(jevents, name), name

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

    def test_router_and_shipper_defaults(self):
        """The router's policy, views and constructor and the handoff's
        shipper and fronts keep the reference's constants and
        defaults."""
        import dataclasses
        import inspect

        from tony_tpu.serve import disagg as jdisagg
        from tony_tpu.serve import router as jrouter
        from tony_tpu_torch.serve import disagg, router

        for cls in ("RouterPolicy", "ReplicaView"):
            ours = {f.name: f.default
                    for f in dataclasses.fields(getattr(router, cls))}
            ref = {f.name: f.default
                   for f in dataclasses.fields(getattr(jrouter, cls))}
            assert ours == ref, cls
        pairs = [(router.RequestRouter.__init__,
                  jrouter.RequestRouter.__init__),
                 (router.RouterServer.__init__,
                  jrouter.RouterServer.__init__),
                 (router.RequestRouter.dispatch,
                  jrouter.RequestRouter.dispatch),
                 (disagg.KVShipper.__init__, jdisagg.KVShipper.__init__),
                 (disagg.PrefillFront.__init__,
                  jdisagg.PrefillFront.__init__)]
        for a, b in pairs:
            assert inspect.signature(a) == inspect.signature(b), a
        assert vars(disagg.KVShipper()) == vars(jdisagg.KVShipper())
        assert disagg.encode_f32([1.5, -2.0]) == \
            jdisagg.encode_f32([1.5, -2.0])
        err = IOError("x")
        assert disagg._classify(err) == jdisagg._classify(err)
        for msg in ("AdmissionError: full", "HandoffError: crc", "other"):
            e = RuntimeError(msg)
            assert disagg._classify(e) == jdisagg._classify(e), msg

    def test_aot_constants_and_fingerprint_key(self):
        """The store's layout and addressing are the reference's: the
        entry prefix, the format tag, the chunk size, and the key a
        fingerprint dict addresses (the port's fingerprints carry other
        fields, so no entry of one package ever hits in the other)."""
        assert (aot._PREFIX, aot.FORMAT, aot.CHUNK_BYTES) == \
            (jaot._PREFIX, jaot.FORMAT, jaot.CHUNK_BYTES)
        for fp in ({}, {"format": aot.FORMAT, "kind": "serve_step",
                        "geometry": {"b": 4, "t": 16}, "model": "x",
                        "extra": {"libraries": ["a.so"]}},
                   aot.make_fingerprint("train_step", device="cpu",
                                        geometry={"microbatches": 2})):
            assert aot.fingerprint_key(fp) == jaot.fingerprint_key(fp)
        assert {"jax", "jaxlib"}.isdisjoint(
            aot.make_fingerprint("unit", device="cpu"))

    def test_events_reader(self, tmp_path):
        """The JAX writer's history, read through the copy and the
        original: the same jobs, metadata and records."""
        done = jevents.EventHandler(tmp_path, "app_done",
                                    conf_snapshot={"a": "1"})
        done.serve_window("serve", 0, {"qps": 1.0,
                                       "prompt_hist": {"16": 2.0}})
        done.close()
        live = jevents.EventHandler(tmp_path, "app_live")
        live.serve_window("serve", 1, {"prompt_hist": {"32": 1.0}})
        live.emit(jevents.TASK_STARTED, job_type="serve", index=1)
        try:
            ours = list(events.list_jobs(tmp_path))
            ref = list(jevents.list_jobs(tmp_path))
            assert ours == ref and [j["state"] for j in ours] == \
                ["finished", "running"]
            for job in ours:
                assert events.read_events(job["path"]) == \
                    jevents.read_events(job["path"])
                assert events.job_metadata(job["path"]) == \
                    jevents.job_metadata(job["path"])
            assert list(events.list_jobs(tmp_path / "none")) == []
        finally:
            live.close()
        assert events.SERVE_WINDOW == jevents.SERVE_WINDOW
