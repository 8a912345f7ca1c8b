"""Data parallelism of the port on the CPU: ``tony_tpu_torch.distributed``
(rendezvous from the PyTorchRuntime env), ``parallel.MeshSpec``, the
data-parallel ``make_train_step``/``create_train_state`` on gloo —
two ranks in subprocesses against one process on the concatenated global
batch and against the JAX package's ``make_train_step`` — and a
two-worker ``--framework pytorch`` MiniPod job training through
``train_loop`` (tests/workloads/torch_dp_train.py)."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as td

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from tony_tpu import train as jtrain
from tony_tpu.minipod import MiniPod
from tony_tpu.models import get_model as jax_model
from tony_tpu.session import TaskStatus
from torch_ranks import wait_ranks
from tony_tpu_torch import constants, distributed, profiler
from tony_tpu_torch import train as ttrain
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params, params_from_jax
from tony_tpu_torch.parallel import AXES, DATA, MeshSpec

ROOT = Path(__file__).resolve().parent.parent
WORKLOADS = Path(__file__).parent / "workloads"
RANK_TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def no_job_env(monkeypatch):
    for name in (constants.ENV_MASTER_ADDR, constants.ENV_MASTER_PORT,
                 constants.ENV_RANK, constants.ENV_WORLD_SIZE,
                 constants.ENV_LOCAL_RANK, constants.ENV_INIT_METHOD):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def one_rank_group(no_job_env):
    td.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                          f"{_free_port()}", rank=0, world_size=1)
    profiler.reset_collective_records()
    try:
        yield
    finally:
        td.destroy_process_group()
        profiler.reset_collective_records()


@pytest.mark.usefixtures("no_job_env")
class TestDistributed:
    def test_env_spec_from_the_pytorch_runtime_env(self, monkeypatch):
        assert distributed.env_spec() is None
        assert (distributed.process_id(), distributed.num_processes()) \
            == (0, 1)
        monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "1234")
        monkeypatch.setenv("RANK", "3")
        monkeypatch.setenv("WORLD_SIZE", "4")
        assert distributed.env_spec() == ("tcp://10.0.0.1:1234", 4, 3, 0)
        monkeypatch.setenv("INIT_METHOD", "tcp://h:9")
        monkeypatch.setenv("LOCAL_RANK", "1")
        assert distributed.env_spec() == ("tcp://h:9", 4, 3, 1)
        assert (distributed.process_id(), distributed.num_processes()) \
            == (3, 4)

    def test_matches_the_runtime_adapter(self):
        """The env the PyTorchRuntime builds for task 1 of two parses to
        rank 1 of a world of 2 at the rank-0 task's address."""
        from tony_tpu.conf import TonyConfig
        from tony_tpu.runtime import TaskContext, get_framework

        conf = TonyConfig({"tony.worker.instances": "2",
                           "tony.application.framework": "pytorch"})
        ctx = TaskContext(conf=conf, job_type="worker", index=1,
                          cluster_spec={"worker": ["h0:7001", "h1:7002"]},
                          am_address="am:9000", app_id="app_1_0001")
        env = get_framework("pytorch").task_adapter().build_task_env(ctx)
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            assert distributed.env_spec() == ("tcp://h0:7001", 2, 1, 0)

    def test_initialize_is_false_outside_a_job_or_for_one_process(
            self, monkeypatch):
        assert distributed.initialize(device="cpu") is False
        monkeypatch.setenv("INIT_METHOD", "tcp://127.0.0.1:1")
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "1")
        assert distributed.initialize(device="cpu") is False
        assert not td.is_initialized()

    def test_the_card_by_default_and_no_fallback(self, monkeypatch):
        """``device=None`` means the card: without a GPU initialize and
        MeshSpec.build raise, in a job or not, and never fall back to
        gloo on the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            distributed.initialize()
        monkeypatch.setenv("INIT_METHOD", "tcp://127.0.0.1:1")
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(RuntimeError, match="is_available"):
            distributed.initialize()
        with pytest.raises(RuntimeError, match="is_available"):
            MeshSpec().build()
        assert not td.is_initialized()


class TestMesh:
    def test_needs_a_process_group(self, no_job_env):
        with pytest.raises(RuntimeError, match="initialize"):
            MeshSpec().build(device="cpu")

    @pytest.mark.parametrize("axis", ["fsdp", "pp", "ep", "sp", "tp",
                                      "slices"])
    def test_other_axes_name_item_8(self, axis):
        """The fsdp, pipeline, expert, sequence and tensor axes are ported
        (tests/test_torch_zero3.py, tests/test_torch_pipeline.py,
        tests/test_torch_moe_ep.py, tests/test_torch_tp.py): their meshes
        ask for the process group. The multi-slice axis names item 8."""
        if axis in ("fsdp", "pp", "ep", "sp", "tp"):
            with pytest.raises(RuntimeError, match="initialize"):
                MeshSpec(**{axis: 2}).build(device="cpu")
            return
        with pytest.raises(NotImplementedError, match="item 8"):
            MeshSpec(**{axis: 2}).build(device="cpu")

    def test_data_mesh_over_the_world(self, one_rank_group):
        mesh = MeshSpec(dp=0).build(device="cpu")
        assert mesh.shape == dict.fromkeys(AXES, 1) and mesh.processes == 1
        assert mesh.device == torch.device("cpu")
        assert MeshSpec(dp=1).build(device="cpu").shape[DATA] == 1
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            MeshSpec(dp=2).build(device="cpu")

    def test_one_rank_step_is_the_plain_step(self, one_rank_group,
                                             monkeypatch):
        """On a one-rank mesh the data-parallel step (broadcast, bucketed
        all_reduce, mean over one rank) changes no bit: loss, metrics and
        every parameter equal the step without a mesh after two steps,
        and the step records its reduce plan under the reference's
        schema, one entry per bucket summing to the grad bytes (32 KiB
        buckets here, so llama-tiny's 417 KiB of grads take several)."""
        monkeypatch.setattr(ttrain, "DEFAULT_BUCKET_BYTES", 32768)
        mesh = MeshSpec().build(device="cpu")
        tok = torch.from_numpy(np.random.RandomState(0).randint(
            0, 256, (2, 17)))
        models = [get_model("llama-tiny", device="cpu", xent_chunk=8,
                            seed=5) for _ in range(2)]
        runs = []
        for model, m in zip(models, (mesh, None)):
            state = ttrain.create_train_state(model, ttrain.adamw(1e-3),
                                              mesh=m)
            step = ttrain.make_train_step(
                loss_of=lambda out, b: out, mesh=m,
                apply_kwargs_of=lambda b: {"targets": b["x"]})
            batch = ttrain.global_batch(mesh, {"x": tok})
            runs.append([step(state, batch)[1] for _ in range(2)])
            assert all(p.grad is None for p in model.parameters())
        for got, ref in zip(*runs):
            for key in ("loss", "grad_norm", "aux_loss"):
                assert torch.equal(got[key], ref[key]), key
        for (name, a), (_, b) in zip(models[0].named_parameters(),
                                     models[1].named_parameters()):
            assert torch.equal(a, b), name
        [rec] = profiler.collective_report().values()
        assert rec["kind"] == "all_reduce" and rec["plane"] == "grad_reduce"
        assert rec["axes"] == ["data"] and len(rec["nbytes"]) > 1
        assert sum(rec["nbytes"]) == sum(p.numel() * p.element_size()
                                         for p in models[0].parameters())

    def test_state_off_the_mesh_device_raises(self, one_rank_group):
        mesh = MeshSpec().build(device="cpu")
        mesh.device = torch.device("meta")
        with pytest.raises(ValueError, match="mesh's device"):
            ttrain.create_train_state(get_model("llama-tiny", device="cpu"),
                                      ttrain.adamw(1e-3), mesh=mesh)


def _jax_reference(tokens, steps):
    """JAX llama-tiny (f32, xent_chunk=8) params, and its make_train_step
    run ``steps`` SGD(0.1) steps on the whole batch."""
    model = jax_model("llama-tiny", dtype=jnp.float32, xent_chunk=8)
    params = nn.unbox(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(tokens)))["params"]
    init = jax.tree.map(np.asarray, params)     # the step donates params
    state = jtrain.create_train_state(model, optax.sgd(0.1),
                                      jnp.asarray(tokens),
                                      jax.random.PRNGKey(0))
    state = state.replace(params=params, opt_state=state.tx.init(params))
    step = jtrain.make_train_step(
        loss_of=lambda out, batch: out,
        apply_kwargs_of=lambda batch: {"targets": batch["x"]})
    metrics = []
    for _ in range(steps):
        state, m = step(state, {"x": jnp.asarray(tokens)})
        metrics.append({k: float(v) for k, v in m.items()})
    return init, state.params, metrics


def _run_ranks(world, src, out_prefix):
    """``world`` gloo ranks of tests/workloads/torch_dp_steps.py, each
    killed at RANK_TIMEOUT_S."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port),
                   INIT_METHOD=f"tcp://127.0.0.1:{port}",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT), os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKLOADS / "torch_dp_steps.py"), str(src),
             f"{out_prefix}{rank}"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    wait_ranks(procs, RANK_TIMEOUT_S, "torch_dp_steps.py")


def test_two_gloo_ranks_match_one_process_and_jax(tmp_path):
    """Two ranks, each on its half of a [4, 17] global batch, three
    SGD(0.1) steps with the chunked loss: the replicas stay bitwise
    equal, and their parameters (per tensor, ||Δ|| / ||ref||), loss and
    grad norm match one process stepping on the whole batch and the JAX
    package's make_train_step on it within f32 1e-5 relative, and each
    step reduces the grad bytes once. (SGD moves a parameter by lr × its
    grad, so the parameters carry the grads' agreement; AdamW's first
    steps would scale one near-zero grad's last-bit difference between
    the frameworks, which is no property of the data parallelism.)"""
    steps = 3
    tokens = np.random.RandomState(11).randint(0, 256, (4, 17)).astype(
        np.int32)
    params, jparams, jmetrics = _jax_reference(tokens, steps)
    init = params_from_jax(params)
    src = tmp_path / "init.npz"
    np.savez(src, tokens=tokens, **{k: v.numpy() for k, v in init.items()})
    _run_ranks(2, src, tmp_path / "rank")

    one = load_jax_params(get_model("llama-tiny", device="cpu",
                                    dtype=torch.float32, xent_chunk=8),
                          params)
    state = ttrain.create_train_state(one, ttrain.sgd(0.1))
    step = ttrain.make_train_step(
        loss_of=lambda out, batch: out,
        apply_kwargs_of=lambda batch: {"targets": batch["x"]})
    one_metrics = [{k: float(v) for k, v in
                    step(state, {"x": torch.from_numpy(tokens)})[1].items()}
                   for _ in range(steps)]

    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    reports = [json.loads((tmp_path / f"rank{r}.json").read_text())
               for r in range(2)]
    for name in ranks[0]:
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name],
                                      err_msg=name)
    assert reports[0]["metrics"] == reports[1]["metrics"]
    assert reports[0]["world"] == 2
    jref = params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in one.named_parameters():
        for ref in (p.detach().numpy(), jref[name].numpy()):
            rel = np.linalg.norm(ranks[0][name] - ref) / np.linalg.norm(ref)
            assert rel <= 1e-5, (name, rel)
    for got, mine, ref in zip(reports[0]["metrics"], one_metrics, jmetrics):
        for key in ("loss", "grad_norm"):
            assert got[key] == pytest.approx(mine[key], rel=1e-5), key
            assert got[key] == pytest.approx(ref[key], rel=1e-5), key
        assert got["aux_loss"] == 0.0
    [rec] = reports[0]["collectives"].values()
    assert sum(rec["nbytes"]) == 4 * sum(v.size for v in ranks[0].values())


def test_pytorch_framework_dp_training_e2e(tmp_path):
    """The reference's test_jax_distributed_dp_training with
    ``--framework pytorch``: two MiniPod workers join one gloo group from
    the PyTorchRuntime env and train the port's decoder through
    train_loop; every task succeeds, the world is 2 and the loss falls."""
    pod = MiniPod(tmp_path)
    job = pod.run({
        "tony.application.framework": "pytorch",
        "tony.worker.instances": "2",
        "tony.application.executes": "python torch_dp_train.py",
        "tony.am.gang-allocation-timeout-ms": "120000",
        "tony.task.max-missed-heartbeats": "100",
    }, src_dir=WORKLOADS, timeout=240)
    for t in job.session.tasks():
        assert t.status is TaskStatus.SUCCEEDED, (t.task_id, t.diagnostics)
    assert job.exit_code == 0
    [result] = Path(job.am.job_dir).glob(
        "containers/*/src/torch_dp_losses.json")
    data = json.loads(result.read_text())
    assert data["world_size"] == 2
    assert data["losses"][-1] < data["losses"][0]
