"""The port stands alone and runs on the card by default.

Import purity is checked statically (``ast``): the test process already
holds jax — other test files in the same worker, and the parity tests'
JAX side, load it — so ``sys.modules`` cannot tell whether the port
imported it."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

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
