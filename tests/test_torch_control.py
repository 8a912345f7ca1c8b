"""The port's control plane held against the JAX package's on the same
inputs: the conf (every shared key, default and getter; validation
differs only in the GPU and TPU asks, the framework set and the backend
name), the GPU census, the runtime adapters (the card pinning equal to
the JAX chip rule, the rest of the env equal to the JAX adapters'), the
session's scenarios run over both modules, the scheduler's GPU accounting
and SSH argv, ``distributed``'s card choice, the executor's stdlib
checkpoint scans, the ``serve`` CLI's conf, and one serve job through the
port's own client (the mirror of ``tests/test_torch_replica.py``'s)."""

from __future__ import annotations

import json
import os
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tony_tpu import cli as jcli
from tony_tpu import conf as jconf
from tony_tpu import constants as jconstants
from tony_tpu import scheduler as jscheduler
from tony_tpu.runtime import TaskContext as JTaskContext
from tony_tpu.runtime import get_framework as jget_framework
from tony_tpu_torch import (ckpt, ckpt_layout, cli, conf, constants,
                            discovery, publish)
from tony_tpu_torch import distributed as dist
from tony_tpu_torch import executor, scheduler
from tony_tpu_torch.am import ApplicationMaster, refuse_unported
from tony_tpu_torch.runtime import TaskContext, get_framework
from tony_tpu_torch.runtime.base import visible_cards

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# Conf
# ---------------------------------------------------------------------------

_VALIDATE_CASES = {
    "no_jobtype": {},
    "plain": {"tony.worker.instances": "2"},
    "vcores_zero": {"tony.worker.instances": "1", "tony.worker.vcores": "0"},
    "sidecars": {"tony.worker.instances": "2", "tony.ps.instances": "1",
                 "tony.tensorboard.instances": "1"},
    "standalone": {"tony.worker.instances": "1",
                   "tony.application.framework": "standalone"},
}


def _verdict(cfg_cls, props):
    try:
        cfg_cls(props).validate()
        return "ok"
    except ValueError as e:
        return type(e).__name__


class TestConf:
    @pytest.mark.parametrize("case", sorted(_VALIDATE_CASES))
    def test_validation_equal_off_the_gpu_tpu_and_framework_axes(self, case):
        props = dict(_VALIDATE_CASES[case],
                     **{"tony.application.framework": "pytorch"}
                     if "tony.application.framework"
                     not in _VALIDATE_CASES[case] else {})
        assert _verdict(conf.TonyConfig, props) == \
            _verdict(jconf.TonyConfig, props)

    def test_gpu_asks_accepted_tpu_asks_refused(self):
        base = {"tony.worker.instances": "2",
                "tony.application.framework": "pytorch"}
        conf.TonyConfig({**base, "tony.worker.gpus": "1"}).validate()
        with pytest.raises(ValueError, match="GPUs cannot be scheduled"):
            jconf.TonyConfig({**base, "tony.worker.gpus": "1"}).validate()
        with pytest.raises(ValueError, match=r"tony\.worker\.tpus: TPU chips "
                           r"cannot be scheduled on the GPU substrate; ask "
                           r"for cards with tony\.worker\.gpus"):
            conf.TonyConfig({**base, "tony.worker.tpus": "4"}).validate()
        jconf.TonyConfig({**base, "tony.worker.tpus": "4"}).validate()
        with pytest.raises(ValueError, match="must be >= 0"):
            conf.TonyConfig({**base, "tony.worker.gpus": "-1"}).validate()

    def test_frameworks_and_backend(self):
        base = {"tony.worker.instances": "1"}
        assert conf.TonyConfig(base).get(conf.APPLICATION_FRAMEWORK) == \
            "pytorch"
        conf.TonyConfig(base).validate()
        for fw in ("jax", "tensorflow", "horovod", "mxnet"):
            with pytest.raises(ValueError, match="known: \\['pytorch', "
                               "'standalone'\\]"):
                conf.TonyConfig({**base, conf.APPLICATION_FRAMEWORK: fw}
                                ).validate()
        with pytest.raises(ValueError, match="backend=ssh"):
            conf.TonyConfig({**base, "tony.scheduler.backend": "tpu-vm"}
                            ).validate()

    def test_discovery_getters_and_serialization(self, tmp_path):
        props = {"tony.chief.instances": "1", "tony.worker.instances": "3",
                 "tony.ps.instances": "1", "tony.zeta.instances": "0",
                 "tony.application.instances": "9",
                 "tony.worker.memory": "3g", "tony.worker.vcores": "2",
                 "tony.worker.gpus": "1", "tony.worker.env": "A=1,B=x=y",
                 "tony.application.untracked.jobtypes": "ps,tensorboard"}
        ours, ref = conf.TonyConfig(props), jconf.TonyConfig(props)
        assert ours.job_types() == ref.job_types() == ["chief", "ps",
                                                       "worker"]
        for jt in ours.job_types():
            assert ours.instances(jt) == ref.instances(jt)
            assert ours.task_env(jt) == ref.task_env(jt)
            assert ours.is_tracked(jt) == ref.is_tracked(jt)
            a, b = ours.container_request(jt), ref.container_request(jt)
            assert [getattr(a, f) for f in a.__slots__] == \
                [getattr(b, f) for f in b.__slots__]
        assert ours.total_tasks() == ref.total_tasks() == 5
        assert ours.get_memory_mb("tony.worker.memory") == 3072
        back = conf.TonyConfig.from_json(ours.to_json())
        assert dict(back.items()) == dict(ours.items())
        ours.save(tmp_path / "c.json")
        assert dict(jconf.TonyConfig.load(tmp_path / "c.json").items()) == \
            dict(ours.items())


# ---------------------------------------------------------------------------
# GPU census
# ---------------------------------------------------------------------------

_SMI_XML = """<?xml version="1.0" ?>
<!DOCTYPE nvidia_smi_log SYSTEM "nvsmi_device_v12.dtd">
<nvidia_smi_log>
  <attached_gpus>2</attached_gpus>
  <gpu id="00000000:18:00.0">
    <product_name>NVIDIA H100 80GB HBM3</product_name>
    <uuid>GPU-aaaaaaaa-1111-2222-3333-444444444444</uuid>
    <minor_number>1</minor_number>
    <fb_memory_usage><total>81559 MiB</total><used>0 MiB</used></fb_memory_usage>
  </gpu>
  <gpu id="00000000:2A:00.0">
    <product_name>NVIDIA H100 80GB HBM3</product_name>
    <uuid>GPU-bbbbbbbb-5555-6666-7777-888888888888</uuid>
    <minor_number>0</minor_number>
    <fb_memory_usage><total>81559 MiB</total><used>0 MiB</used></fb_memory_usage>
  </gpu>
</nvidia_smi_log>
"""
_UUIDS = ("GPU-aaaaaaaa-1111-2222-3333-444444444444",
          "GPU-bbbbbbbb-5555-6666-7777-888888888888")


class TestCensus:
    @pytest.fixture
    def smi(self, monkeypatch):
        monkeypatch.setattr(discovery, "_devices_from_nvidia_smi",
                            lambda: discovery.parse_nvidia_smi_xml(_SMI_XML))

    def test_parse_two_cards(self):
        devs = discovery.parse_nvidia_smi_xml(_SMI_XML)
        assert [(d.index, d.uuid, d.name, d.memory_mib) for d in devs] == [
            (0, _UUIDS[0], "NVIDIA H100 80GB HBM3", 81559),
            (1, _UUIDS[1], "NVIDIA H100 80GB HBM3", 81559)]

    @pytest.mark.parametrize("visible,want", [
        (None, [0, 1]), ("1", [1]), ("1,0", [1, 0]), ("", []),
        (_UUIDS[1], [1]), (_UUIDS[1][:12] + "," + _UUIDS[0], [1, 0]),
        ("0,7,1", [0]), ("GPU-zz", [])],
        ids=["unset", "index", "order", "empty", "uuid", "uuid-prefix",
             "stops-at-unknown", "unknown-uuid"])
    def test_visible_restriction(self, smi, visible, want):
        env = {} if visible is None else {"CUDA_VISIBLE_DEVICES": visible}
        topo = discovery.discover_gpus(env=env)
        assert topo.source == "nvidia-smi"
        assert [d.index for d in topo.devices] == want
        assert topo.num_gpus == len(want)

    def test_devfs_and_none(self, tmp_path, monkeypatch):
        monkeypatch.setattr(discovery, "_devices_from_nvidia_smi",
                            lambda: None)
        for name in ("nvidia0", "nvidia1", "nvidia2", "nvidiactl",
                     "nvidia-uvm"):
            (tmp_path / name).touch()
        pattern = str(tmp_path / "nvidia[0-9]*")
        monkeypatch.setattr(discovery, "_devices_from_devfs",
                            lambda real=discovery._devices_from_devfs:
                            real(pattern))
        topo = discovery.discover_gpus(env={"CUDA_VISIBLE_DEVICES": "2,0"})
        assert (topo.source, topo.num_gpus) == ("devfs", 2)
        assert [d.index for d in topo.devices] == [2, 0]
        monkeypatch.setattr(discovery, "_devices_from_devfs", lambda: None)
        assert discovery.discover_gpus(env={}) == \
            discovery.GpuTopology(0, "none")

    def test_torch_source_is_last_and_opt_in(self, monkeypatch):
        """Without ``nvidia-smi`` and device nodes, ``use_torch`` counts
        the cards torch sees (its properties' UUIDs as nvidia-smi writes
        them); a CUDA runtime that raises, or no opt-in, counts none."""
        monkeypatch.setattr(discovery, "_devices_from_nvidia_smi",
                            lambda: None)
        monkeypatch.setattr(discovery, "_devices_from_devfs", lambda: None)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i: types.SimpleNamespace(
                                name="NVIDIA H100 80GB HBM3",
                                total_memory=81559 << 20,
                                uuid=_UUIDS[i][len("GPU-"):]))
        assert discovery.discover_gpus(env={}) == \
            discovery.GpuTopology(0, "none")
        topo = discovery.discover_gpus(use_torch=True, env={})
        assert topo == discovery.GpuTopology(
            2, "torch", tuple(discovery.parse_nvidia_smi_xml(_SMI_XML)))

        def broken(i):
            raise RuntimeError("CUDA initialization failed")
        monkeypatch.setattr(torch.cuda, "get_device_properties", broken)
        assert discovery.discover_gpus(use_torch=True, env={}) == \
            discovery.GpuTopology(0, "none")

    def test_am_census_opts_into_torch(self, tmp_path, monkeypatch):
        """The AM takes the census with the torch source on, as the
        reference AM takes its chip census with jax on."""
        asked = []
        monkeypatch.setattr(discovery, "discover_gpus",
                            lambda use_torch=False, env=None:
                            asked.append(use_torch)
                            or discovery.GpuTopology(1, "torch"))
        am = ApplicationMaster(conf.TonyConfig(
            {"tony.worker.instances": "1", "tony.worker.gpus": "1",
             "tony.application.framework": "standalone"}),
            "app_t", tmp_path / "j")
        assert asked == [True] and am.scheduler.total_gpus == 1

    def test_am_refuses_gpu_ask_on_cardless_host(self, tmp_path,
                                                 monkeypatch):
        """Mirrors ``tests/test_satellites.py``'s chip test: gpus>0 with
        no card found fails loudly, never an unlimited launch;
        ``tony.scheduler.total-gpus`` overrides; no ask, no census."""
        monkeypatch.setattr(discovery, "discover_gpus",
                            lambda use_torch=False, env=None:
                            discovery.GpuTopology(0, "none"))
        props = {"tony.worker.instances": "1", "tony.worker.gpus": "1",
                 "tony.application.framework": "standalone"}
        with pytest.raises(ValueError, match="no GPUs discovered"):
            ApplicationMaster(conf.TonyConfig(props), "app_t", tmp_path / "j")
        am = ApplicationMaster(
            conf.TonyConfig({**props, "tony.scheduler.total-gpus": "8"}),
            "app_t2", tmp_path / "j2")
        assert am.scheduler.total_gpus == 8
        monkeypatch.setattr(discovery, "discover_gpus",
                            lambda use_torch=False, env=None:
                            discovery.GpuTopology(2, "nvidia-smi"))
        am = ApplicationMaster(conf.TonyConfig(props), "app_t3",
                               tmp_path / "j3")
        assert am.scheduler.total_gpus == 2
        del props["tony.worker.gpus"]
        am = ApplicationMaster(conf.TonyConfig(props), "app_t4",
                               tmp_path / "j4")
        assert am.scheduler.total_gpus == 0


# ---------------------------------------------------------------------------
# Runtime adapters
# ---------------------------------------------------------------------------

# (asks by job type, placement of each job type's tasks on hosts)
_CLUSTERS = {
    "one_host_uniform": ({"worker": 2}, {"worker": ["h0", "h0", "h0"]}),
    "two_hosts": ({"worker": 1}, {"worker": ["h0", "h1", "h0", "h1"]}),
    "mixed_cohort": ({"chief": 2, "worker": 1},
                     {"chief": ["h0"], "worker": ["h0", "h0", "h1"]}),
    "sidecars": ({"worker": 1, "tensorboard": 1},
                 {"worker": ["h0", "h0"], "tensorboard": ["h0"]}),
    "partial_asks": ({"worker": 1},
                     {"worker": ["h0", "h0"], "evaluator": ["h0"]}),
}
_SETTINGS = {"tony.ckpt.dir": "/ckpt", "tony.ckpt.every": "2",
             "tony.publish.every": "3", "tony.train.aot-cache": "/aot",
             "tony.data.seed": "7", "tony.worker.env": "A=1"}


def _contexts(ctx_cls, conf_cls, asks, placement, key, settings):
    props = {f"tony.{jt}.instances": str(len(hosts))
             for jt, hosts in placement.items()}
    props.update({f"tony.{jt}.{key}": str(n) for jt, n in asks.items()})
    props.update(settings)
    cfg = conf_cls(props)
    spec = {jt: [f"{h}:{4000 + 10 * i + j}" for j, h in enumerate(hosts)]
            for i, (jt, hosts) in enumerate(sorted(placement.items()))}
    return [ctx_cls(conf=cfg, job_type=jt, index=i, cluster_spec=spec,
                    am_address="am:1", app_id="app_1")
            for jt in cfg.job_types() for i in range(cfg.instances(jt))]


class TestAdapters:
    @pytest.mark.parametrize("name", sorted(_CLUSTERS))
    def test_card_pinning_is_the_jax_chip_rule(self, name, monkeypatch):
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        asks, placement = _CLUSTERS[name]
        ours = _contexts(TaskContext, conf.TonyConfig, asks, placement,
                         "gpus", {})
        ref = _contexts(JTaskContext, jconf.TonyConfig, asks, placement,
                        "tpus", {})
        jax_adapter = jget_framework("jax").task_adapter()
        for fw in ("pytorch", "standalone"):
            adapter = get_framework(fw).task_adapter()
            for a, b in zip(ours, ref):
                env = adapter.build_task_env(a)
                chips = jax_adapter.framework_env(b).get(
                    jconstants.ENV_TPU_VISIBLE_DEVICES)
                assert env.get(constants.ENV_CUDA_VISIBLE_DEVICES) == chips, \
                    (fw, a.job_type, a.index)
                pinned = chips is not None
                assert (constants.ENV_TASK_GPUS in env) == pinned
                if pinned:
                    assert env[constants.ENV_TASK_GPUS] == \
                        str(len(chips.split(",")))
                    assert env[constants.ENV_CUDA_DEVICE_ORDER] == \
                        "PCI_BUS_ID"

    @pytest.mark.parametrize("name", sorted(_CLUSTERS))
    def test_rest_of_the_env_is_the_jax_adapters(self, name, monkeypatch):
        """Off the card seams, the env is the JAX package's
        PyTorchTaskAdapter env plus the settings its JAXRuntime exports."""
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        asks, placement = _CLUSTERS[name]
        ours = _contexts(TaskContext, conf.TonyConfig, asks, placement,
                         "gpus", _SETTINGS)
        ref = _contexts(JTaskContext, jconf.TonyConfig, asks, placement,
                        "gpus", _SETTINGS)
        adapter = get_framework("pytorch").task_adapter()
        jtorch = jget_framework("pytorch").task_adapter()
        jjax = jget_framework("jax").task_adapter()
        seams = {constants.ENV_CUDA_VISIBLE_DEVICES,
                 constants.ENV_CUDA_DEVICE_ORDER, constants.ENV_TASK_GPUS}
        settings = (jconstants.ENV_CKPT_DIR, jconstants.ENV_CKPT_EVERY,
                    jconstants.ENV_CKPT_KEEP, jconstants.ENV_PUBLISH_EVERY,
                    jconstants.ENV_TRAIN_AOT_CACHE,
                    jconstants.ENV_DATA_SEED)
        for a, b in zip(ours, ref):
            env = {k: v for k, v in adapter.build_task_env(a).items()
                   if k not in seams}
            want = jtorch.build_task_env(b)
            jax_env = jjax.framework_env(b)
            want.update({k: jax_env[k] for k in settings if k in jax_env})
            if not b.is_sidecar():
                want[constants.ENV_NCCL_ASYNC_ERROR_HANDLING] = "1"
                assert want[constants.ENV_CKPT_DIR] == "/ckpt"
                assert want[constants.ENV_PUBLISH_EVERY] == "3"
            assert env == want, (a.job_type, a.index)

    def test_nccl_setting_yields_to_the_conf_env(self):
        (ctx,) = _contexts(TaskContext, conf.TonyConfig, {}, {"worker":
                                                              ["h0"]},
                           "gpus", {"tony.worker.env":
                                    "TORCH_NCCL_ASYNC_ERROR_HANDLING=0"})
        env = get_framework("pytorch").task_adapter().build_task_env(ctx)
        assert env[constants.ENV_NCCL_ASYNC_ERROR_HANDLING] == "0"

    def test_host_restriction_maps_the_offset(self):
        asks, placement = {"worker": 1, "chief": 2}, \
            {"chief": ["h0"], "worker": ["h0", "h0"]}
        ctxs = _contexts(TaskContext, conf.TonyConfig, asks, placement,
                         "gpus", {})
        host = {"CUDA_VISIBLE_DEVICES": "3, 5,GPU-x,7"}
        assert [visible_cards(c, host) for c in ctxs] == \
            [["3", "5"], ["GPU-x"], ["7"]]
        with pytest.raises(RuntimeError, match="sees only"):
            visible_cards(ctxs[2], {"CUDA_VISIBLE_DEVICES": "3,5,6"})


# ---------------------------------------------------------------------------
# Session: tests/test_session.py's scenarios over both modules
# ---------------------------------------------------------------------------

def _session_suite(package):
    src = (ROOT / "tests" / "test_session.py").read_text()
    if package == "tony_tpu_torch":
        src = src.replace("from tony_tpu.", "from tony_tpu_torch.")
    mod = types.ModuleType(f"session_suite_{package}")
    exec(compile(src, f"test_session[{package}]", "exec"), mod.__dict__)
    return mod


_SESSION_TESTS = sorted(n for n in vars(_session_suite("tony_tpu"))
                        if n.startswith("test_"))


@pytest.mark.parametrize("package", ["tony_tpu", "tony_tpu_torch"])
@pytest.mark.parametrize("name", _SESSION_TESTS)
def test_session_scenarios(package, name):
    mod = _session_suite(package)
    assert mod.TonySession.__module__ == f"{package}.session"
    getattr(mod, name)()


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------

class TestScheduler:
    def test_over_ask_refused_and_cards_released(self, tmp_path):
        sched = scheduler.LocalProcessScheduler(tmp_path, total_gpus=2)
        # No AM env: each executor fails its bootstrap and exits at once.
        env = {constants.ENV_JOB_NAME: "worker"}
        a = sched.launch(scheduler.ContainerLaunch("worker", 0, env, gpus=2))
        assert sched.gpus_in_use == 2
        with pytest.raises(RuntimeError, match="unsatisfiable gpu ask: 1 "
                           "requested, 0 free"):
            sched.launch(scheduler.ContainerLaunch("worker", 1, env, gpus=1))
        deadline = time.monotonic() + 60
        done = []
        while not done and time.monotonic() < deadline:
            done = sched.poll_completed()
            time.sleep(0.05)
        assert [c.container_id for c in done] == [a.container_id]
        assert sched.gpus_in_use == 0
        with open(tmp_path / "containers" / a.container_id /
                  constants.EXECUTOR_LOG_NAME) as fh:
            assert "bootstrap failed" in fh.read()
        sched.launch(scheduler.ContainerLaunch("worker", 1, env, gpus=2))
        assert sched.gpus_in_use == 2
        sched.stop()
        assert sched.gpus_in_use == 0 and not sched.running()

    def test_per_host_placement(self):
        sched = scheduler.SshScheduler(["a", "b"], host_gpus=2)
        hosts = [sched._host_for(scheduler.ContainerLaunch(
            "worker", i, {}, gpus=g)) for i, g in enumerate((2, 1, 1))]
        assert hosts == ["a", "b", "b"]
        with pytest.raises(RuntimeError, match="per-host free"):
            sched._host_for(scheduler.ContainerLaunch("worker", 3, {},
                                                      gpus=1))
        with pytest.raises(RuntimeError, match="hosts have 2"):
            sched._host_for(scheduler.ContainerLaunch("worker", 3, {},
                                                      gpus=3))
        sched._release_host("a", 2)
        assert sched._host_for(scheduler.ContainerLaunch(
            "worker", 4, {}, gpus=1)) == "a"

    def test_ssh_argv_is_the_jax_ones(self, tmp_path):
        env = {constants.ENV_CONF_PATH: str(tmp_path / "tony-job.json"),
               constants.ENV_SRC_DIR: str(tmp_path / "src"),
               constants.ENV_JOB_NAME: "worker", "X": "a b"}
        kw = dict(ssh_cmd="ssh -i key", remote_python="python3",
                  remote_workdir="/w", remote_pythonpath="/w/pkg")
        ours = scheduler.SshScheduler(["h"], host_gpus=4, **kw)
        ref = jscheduler.TpuVmScheduler(["h"], host_tpus=4, **kw)
        got = ours.build_remote_command(
            scheduler.ContainerLaunch("worker", 0, env, gpus=1), "h", cid="c")
        want = ref.build_remote_command(
            jscheduler.ContainerLaunch("worker", 0, env, tpus=1), "h",
            cid="c")
        assert got[:-1] == want[:-1]
        assert got[-1] == want[-1].replace("-m tony_tpu.executor",
                                           "-m tony_tpu_torch.executor")
        assert "-m tony_tpu_torch.executor" in got[-1]
        assert ours.build_stage_command("/src", "h", "src") == \
            ref.build_stage_command("/src", "h", "src")

    def test_backend_from_conf(self, tmp_path):
        cfg = conf.TonyConfig({"tony.scheduler.backend": "ssh",
                               "tony.scheduler.hosts": "a,b,c",
                               "tony.application.node-blacklist": "b",
                               "tony.scheduler.host-gpus": "8"})
        sched = scheduler.scheduler_from_conf(cfg, tmp_path)
        assert isinstance(sched, scheduler.SshScheduler)
        assert (sched.hosts, sched.host_gpus) == (["a", "c"], 8)
        assert scheduler.scheduler_from_conf(conf.TonyConfig(), tmp_path) \
            is None
        with pytest.raises(ValueError, match="backend=ssh"):
            scheduler.scheduler_from_conf(conf.TonyConfig(
                {"tony.scheduler.backend": "tpu-vm"}), tmp_path)


# ---------------------------------------------------------------------------
# The card a task uses
# ---------------------------------------------------------------------------

class TestTaskCard:
    @pytest.fixture
    def calls(self, monkeypatch):
        seen = []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "set_device",
                            lambda i: seen.append(("set_device", i)))
        monkeypatch.setattr(dist.td, "init_process_group",
                            lambda backend, **kw: seen.append((backend, kw)))
        for k in ("TONY_TASK_GPUS", "CUDA_VISIBLE_DEVICES"):
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setenv("RANK", "3")
        monkeypatch.setenv("WORLD_SIZE", "4")
        monkeypatch.setenv("LOCAL_RANK", "1")
        monkeypatch.setenv("INIT_METHOD", "tcp://h:1")
        return seen

    def test_unpinned_task_keeps_local_rank(self, calls):
        assert dist.task_card() == 1
        assert dist.initialize() is True
        assert calls == [("set_device", 1), ("nccl", {
            "init_method": "tcp://h:1", "rank": 3, "world_size": 4})]

    def test_pinned_task_uses_its_first_visible_card(self, calls,
                                                     monkeypatch):
        monkeypatch.setenv("TONY_TASK_GPUS", "1")
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert dist.task_card() == 0
        assert dist.initialize() is True
        assert calls[0] == ("set_device", 0)

    def test_decision_reads_the_export_not_the_count(self, calls,
                                                     monkeypatch):
        """A host that restricts itself to one card, with no TonY pin,
        still means ``cuda:{LOCAL_RANK}``."""
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert dist.task_card() == 1
        monkeypatch.setenv("TONY_TASK_GPUS", "0")
        assert dist.task_card() == 1

    def test_cpu_task_uses_gloo(self, calls):
        assert dist.initialize(device="cpu") is True
        assert calls == [("gloo", {"init_method": "tcp://h:1", "rank": 3,
                                   "world_size": 4})]


# ---------------------------------------------------------------------------
# The executor's checkpoint scans
# ---------------------------------------------------------------------------

def test_executor_scans_equal_the_ckpt_modules(tmp_path):
    """The heartbeat's scans are the checkpoint modules' own (one
    standard-library layout module), and they read what ``ckpt`` and
    ``publish`` write."""
    assert executor.latest_step is ckpt_layout.latest_step \
        is ckpt.latest_step
    assert executor.latest_publication is ckpt_layout.latest_publication \
        is publish.latest_publication
    root = tmp_path / "ck"
    assert executor.latest_step(root) is None
    root.mkdir()
    for name, manifest in (("step_00000002", True), ("step_00000010", True),
                           ("step_00000011.tmp", True),
                           ("step_00000012", False), ("other", True)):
        (root / name).mkdir()
        if manifest:
            (root / name / "manifest.json").write_text("{}")
    assert executor.latest_step(root) == 10
    assert ckpt.committed_steps(root) == [2, 10]
    assert executor.latest_publication(root) is None
    rec = publish.publish_step(root, 10)
    assert executor.latest_publication(root) == rec
    (root / "published.json").write_text("{garbage")
    assert executor.latest_publication(root) is None


# ---------------------------------------------------------------------------
# The serve CLI and the unported parts of the AM
# ---------------------------------------------------------------------------

_SERVE_ARGS = [
    ["--model", "llama-tiny", "--ckpt_dir", "ck"],
    ["--model", "llama2-7b", "--ckpt_dir", "/abs/ck", "--replicas", "3",
     "--model_kwargs", '{"n_layers": 8}', "--dtype_policy", "f32",
     "--ctx_max", "4096", "--prefix_cache", "--prefill_chunk", "256",
     "--aot_cache", "aot", "--name", "srv", "--conf", "tony.serve.port=9"],
    ["--model", "llama-tiny", "--ckpt_dir", "ck", "--spec_k", "4",
     "--draft_model", "llama-tiny", "--draft_model_kwargs",
     '{"n_layers": 1}', "--draft_ckpt_dir", "dck", "--max_replicas", "4",
     "--warm_standby", "1", "--slo_target_ms", "250"],
    ["--model", "llama-tiny", "--ckpt_dir", "ck", "--host_blocks", "64",
     "--prefix_store", "stems", "--demote_watermark", "0.5",
     "--prefix_cache", "--tenants", "gold:3,silver:1",
     "--qos_max_queue", "8"],
]


def _capture_conf(module, monkeypatch):
    seen = []

    class Capture:
        def __init__(self, cfg, **kw):
            seen.append(cfg)

        def run(self, timeout=None):
            return 0

    monkeypatch.setattr(f"{module}.client.TonyClient", Capture)
    return seen


class TestServeCli:
    @pytest.mark.parametrize("args", _SERVE_ARGS,
                             ids=["minimal", "lanes", "spec", "kvtier"])
    @pytest.mark.parametrize("gpus", [None, "2"])
    def test_conf_is_the_jax_clis(self, args, gpus, monkeypatch,
                                  tmp_path):
        monkeypatch.chdir(tmp_path)
        ours = _capture_conf("tony_tpu_torch", monkeypatch)
        ref = _capture_conf("tony_tpu", monkeypatch)
        extra = ["--gpus", gpus] if gpus else []
        assert cli.main(["serve", *args, *extra]) == 0
        assert jcli.main(["serve", *args]) == 0
        got, want = dict(ours[0].items()), dict(ref[0].items())
        assert got.pop("tony.serve.command") == \
            "python -m tony_tpu_torch.serve.replica"
        assert want.pop("tony.serve.command") == \
            "python -m tony_tpu.serve.replica"
        if gpus:
            assert got.pop("tony.serve.gpus") == gpus
        assert got == want
        assert got[conf.APPLICATION_FRAMEWORK] == "standalone"

    @pytest.mark.parametrize("flags,item", [
        (["--tenants", "gold:3"], None),
        (["--role", "prefill=1,decode=1", "--tenants", "gold:3"], None),
        (["--host_blocks", "8"], None), (["--mesh", '{"fsdp": 2}'], 8),
        (["--follow", "/job"], 10)],
        ids=["tenants", "role", "host_blocks", "mesh", "follow"])
    def test_unported_lanes_refused_naming_their_item(self, flags, item,
                                                      monkeypatch,
                                                      tmp_path):
        """A lane the port does not serve is refused at submit naming
        its ROADMAP item; the host tier and the tenants (item ``None``:
        refused before they were ported) now write the JAX CLI's
        conf."""
        args = ["serve", "--model", "m", "--ckpt_dir", "c", *flags]
        if item is not None:
            with pytest.raises(SystemExit, match=f"item {item}\\)$"):
                cli.main(args)
            return
        monkeypatch.chdir(tmp_path)
        ours = _capture_conf("tony_tpu_torch", monkeypatch)
        ref = _capture_conf("tony_tpu", monkeypatch)
        assert cli.main(args) == 0 and jcli.main(args) == 0
        got, want = dict(ours[0].items()), dict(ref[0].items())
        assert {k: v for k, v in got.items() if "command" not in k} == \
            {k: v for k, v in want.items() if "command" not in k}

    @pytest.mark.parametrize("flags,message", [
        (["--tenants", "gold:0"], "--tenants: tenant 'gold'"),
        (["--tenants", "a:1,a:2"], "--tenants: duplicate"),
        (["--qos_max_queue", "2"], "--qos_max_queue needs --tenants"),
        (["--tenants", "g:1", "--qos_max_queue", "-1"], "must be >= 0"),
        (["--host_blocks", "-1"], "--host_blocks must be >= 0"),
        (["--demote_watermark", "0.5"], "needs --host_blocks"),
        (["--host_blocks", "4", "--demote_watermark", "2"],
         "pool fraction")],
        ids=["weight", "duplicate", "cap_alone", "cap_negative",
             "host_negative", "watermark_alone", "watermark_range"])
    def test_kv_tier_and_tenant_flags_validated_as_the_reference(
            self, flags, message):
        args = ["serve", "--model", "m", "--ckpt_dir", "c", *flags]
        with pytest.raises(SystemExit, match=message):
            cli.main(args)
        with pytest.raises(SystemExit, match=message):
            jcli.main(args)

    @pytest.mark.parametrize("props", [
        {"tony.serve.instances": "1", "tony.serve.replicas.max": "3"},
        {"tony.serve.instances": "1", "tony.serve.warm-standby": "1"},
        {"tony.worker.instances": "1", "tony.publish.follow": "true"},
        {"tony.worker.instances": "1", "tony.resize.enabled": "true"},
        {"tony.worker.instances": "1",
         "tony.task.profiler.collect-after-s": "5"},
        {"tony.worker.instances": "1", "tony.docker.enabled": "true"},
        {"tony.worker.instances": "1",
         "tony.security.credential-provider": "m:C"}],
        ids=["autoscaler", "warm_pool", "follow", "resize", "traces",
             "docker", "credentials"])
    def test_client_refuses_unported_am_parts(self, props):
        with pytest.raises(ValueError, match="ROADMAP.md, queue 1 item 10"):
            refuse_unported(conf.TonyConfig(props))
        refuse_unported(conf.TonyConfig(
            {"tony.serve.instances": "2", "tony.serve.replicas.max": "2",
             "tony.security.enabled": "true"}))


def test_tony_serve_job(tmp_path):
    """The port's mirror of ``tests/test_torch_replica.py``'s serve job,
    through the port's own client, AM and executor: ``tony_tpu_torch.cli
    serve --gpus 1`` (the CPU counts as no card, so ``total-gpus``
    stands in for the census) launches the port's replica pinned to card
    0; its stats file carries the RPC port, a generate over the wire
    answers with the in-process replica's tokens, and ``kill`` ends the
    job KILLED."""
    from tony_tpu_torch import train as ttrain
    from tony_tpu_torch.client import TonyClient
    from tony_tpu_torch.models import get_model
    from tony_tpu_torch.rpc import RpcClient
    from tony_tpu_torch.serve import Replica

    root = tmp_path / "ckpt"
    state = ttrain.create_train_state(
        get_model("llama-tiny", device="cpu", dtype=torch.float32, seed=3,
                  n_layers=2), ttrain.adamw(1e-3))
    saver = ckpt.AsyncCheckpointer(root)
    saver.save(ckpt.encode_portable(state), step=2, block=True)
    saver.close()
    kwargs = json.dumps({"n_layers": 2, "device": "cpu"})
    args = cli.make_parser().parse_args([
        "serve", "--model", "llama-tiny", "--model_kwargs", kwargs,
        "--ckpt_dir", str(root), "--gpus", "1", "--ctx_max", "64",
        "--conf", "tony.serve.block-size=8",
        "--conf", "tony.scheduler.total-gpus=1",
        "--conf", "tony.task.heartbeat-interval-ms=200"])
    workdir = tmp_path / "jobs"
    client = TonyClient(cli.serve_conf(args), workdir=workdir, quiet=True)
    client.submit()
    prompt = [int(x) for x in np.random.RandomState(5).randint(0, 256, 9)]
    try:
        deadline = time.monotonic() + 120.0
        payload, stats_path = None, None
        while time.monotonic() < deadline and payload is None:
            for stats_path in client.job_dir.rglob("serve-stats.json"):
                payload = json.loads(stats_path.read_text())
            time.sleep(0.1)
        assert payload is not None, "the replica never published"
        assert payload["weight_step"] == 2.0
        with RpcClient(f"127.0.0.1:{int(payload['rpc_port'])}",
                       timeout=60.0) as rpc_client:
            out = rpc_client.call("generate", tokens=prompt,
                                  max_new_tokens=3)
            launches = rpc_client.call("serve_stats")["launches"]
        ref = Replica(model_name="llama-tiny",
                      model_kwargs={"n_layers": 2, "device": "cpu"},
                      ckpt_dir=str(root), ctx_max=64, block_size=8)
        assert out["tokens"] == ref.generate(prompt, 3).tokens
        assert launches["flash_decode"] == 0      # the CPU: no kernel
        assert cli.main(["kill", client.app_id, "--workdir",
                         str(workdir)]) == 0
        assert client.monitor(timeout=60) == 1
        assert client.final_status == "KILLED"
        env_dump = (stats_path.parent / "stdout.log").read_text()
        assert "listening on" in env_dump
    finally:
        if client.am_proc is not None and client.am_proc.poll() is None:
            client.am_proc.kill()
    conf_saved = conf.TonyConfig.load(client.job_dir / "tony-job.json")
    assert conf_saved.get("tony.serve.gpus") == "1"
    assert conf_saved.get("tony.serve.command") == cli.REPLICA_COMMAND
