"""The port's checkpoint plane for the conv nets and SGD
(tony_tpu_torch.models.convert, .ckpt, .train): the reference's
tests/test_ckpt.py ``TestTrainLoop`` pins on the port's mnist-mlp with
``sgd(0.1, momentum=0.9)``, through ``TONY_CKPT_*`` and through the job
conf at ``TONY_CONF_PATH``; steps of mnist-mlp (with and without
momentum), mnist-cnn and resnet18-thin on both BatchNorm lanes written
by the port and restored by the JAX package, and a JAX mnist-mlp step
restored by the port, every leaf equal, then one more step on each side
within tests/test_torch_train.py's and tests/test_torch_resnet.py's
limits; the permuted leaf view on a channels-last tensor; the piece
planner of staging in pieces (a save in pieces on the card is
tests/test_torch_cuda.py's, which imports no JAX); and the
``--framework pytorch`` gang restart on the MiniPod. Nothing is
recomputed in a round trip, so the comparisons are bitwise unless a
tolerance is stated."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tony_tpu import ckpt as jckpt
from tony_tpu import train as jtrain
from tony_tpu.models import get_model as jget
from tony_tpu_torch import ckpt, constants
from tony_tpu_torch import train as ttrain
from tony_tpu_torch.ckpt import format as fmt
from tony_tpu_torch.ckpt import snapshot
from tony_tpu_torch.ckpt.snapshot import LeafView
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import (conv_params_from_jax,
                                           load_jax_params,
                                           mlp_params_from_jax)
from test_torch_resnet import _jax_train_step, _rename_fused

WORKLOADS = Path(__file__).parent / "workloads"


@pytest.fixture
def clean_train_env(monkeypatch):
    for name in (constants.ENV_CKPT_DIR, constants.ENV_CKPT_EVERY,
                 constants.ENV_CKPT_KEEP, constants.ENV_CONF_PATH,
                 constants.ENV_PUBLISH_EVERY, constants.ENV_DRAIN_FILE,
                 constants.ENV_SERVE_STATS):
        monkeypatch.delenv(name, raising=False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mlp_batch(seed=0, n=16):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, 784), dtype=np.float32),
            "y": rng.integers(0, 10, (n,))}


def _image_batch(seed=0, n=4, size=32):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, size, size, 3), dtype=np.float32),
            "y": rng.integers(0, 10, (n,))}


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _small_mlp_batch(seed=0):
    return _mlp_batch(seed, n=4)


# Each case: the registered net (the port's and the JAX package's), its
# kwargs, the optimizer's momentum, a seeded numpy batch of the case, and
# the BatchNorm lane of a ResNet (None for the MNIST nets).
CASES = {
    "mlp_momentum": ("mnist-mlp", {"hidden": 32}, 0.9, _mlp_batch, None),
    "mlp_sgd": ("mnist-mlp", {"hidden": 32}, None, _mlp_batch, None),
    "cnn": ("mnist-cnn", {}, 0.9, _small_mlp_batch, None),
    "resnet_plain": ("resnet18-thin", {}, 0.9, _image_batch, "plain"),
    "resnet_fused": ("resnet18-thin", {}, 0.9, _image_batch, "fused"),
}


def _port_state(case, seed=0):
    name, kw, momentum, _, lane = CASES[case]
    if lane is not None:
        kw = dict(kw, fused_bn=lane == "fused", dtype=torch.float32)
    model = get_model(name, device="cpu", seed=seed, **kw)
    return ttrain.create_train_state(model, ttrain.sgd(0.1,
                                                       momentum=momentum))


def _port_step(case):
    if CASES[case][4] is None:
        return ttrain.make_train_step()
    return ttrain.make_train_step(
        apply_kwargs_of=lambda b: {"train": True})


_MLP_STEP = ttrain.make_train_step()


def _snapshot_of(state):
    """Parameters, buffers and the momentum trace, cloned."""
    model = state.model
    out = {n: t.detach().clone() for n, t in model.state_dict().items()}
    trace = state.opt_state.trace or []
    names = [n for n, _ in model.named_parameters()]
    out.update({f"trace:{n}": t.clone() for n, t in zip(names, trace)})
    return out, state.step


def _assert_equal_snapshots(a, b):
    (ta, sa), (tb, sb) = a, b
    assert sa == sb
    assert sorted(ta) == sorted(tb)
    for name in ta:
        assert torch.equal(ta[name], tb[name]), name


# ---------------------------------------------------------------------------
# The reference's TestTrainLoop pins on mnist-mlp with SGD
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("clean_train_env")
class TestTrainLoop:
    def test_plain_fold_without_ckpt_dir(self):
        batch = _torch_batch(_mlp_batch())
        final, metrics = ttrain.train_loop(_port_state("mlp_momentum"),
                                           _MLP_STEP, [batch] * 3,
                                           ckpt_dir=None)
        assert final.step == 3 and torch.isfinite(metrics["loss"])

    @pytest.mark.parametrize("through", ["env", "conf"])
    def test_save_every_and_resume(self, tmp_path, monkeypatch, through):
        """Attempt 1 trains 4 steps saving every 2; attempt 2 re-enters
        the same loop from other weights and resumes from the newest
        committed step: parameters and trace ``torch.equal`` to an
        uninterrupted run's. The directory, interval and retention come
        from the ``TONY_CKPT_*`` variables, or from a job conf at
        ``TONY_CONF_PATH`` alone (``tony.ckpt.dir/every/keep``, what the
        JAX runtime exports to a jax task)."""
        root = tmp_path / "c"
        if through == "env":
            monkeypatch.setenv(constants.ENV_CKPT_DIR, str(root))
            monkeypatch.setenv(constants.ENV_CKPT_EVERY, "2")
            monkeypatch.setenv(constants.ENV_CKPT_KEEP, "2")
        else:
            path = tmp_path / "tony-job.json"
            path.write_text(json.dumps({"tony.ckpt.dir": str(root),
                                        "tony.ckpt.every": "2",
                                        "tony.ckpt.keep": "2"}))
            monkeypatch.setenv(constants.ENV_CONF_PATH, str(path))
        batches = [_torch_batch(_mlp_batch(i)) for i in range(6)]
        seen = []
        final, _ = ttrain.train_loop(_port_state("mlp_momentum"), _MLP_STEP,
                                     batches[:4],
                                     on_step=lambda i, m: seen.append(i))
        assert final.step == 4 and seen == [1, 2, 3, 4]
        assert ckpt.latest_step(root) == 4
        resumed, _ = ttrain.train_loop(_port_state("mlp_momentum", seed=1),
                                       _MLP_STEP, batches[4:])
        assert resumed.step == 6
        assert fmt.committed_steps(root) == [4, 6]
        straight, _ = ttrain.train_loop(_port_state("mlp_momentum"),
                                        _MLP_STEP, batches, ckpt_dir="")
        _assert_equal_snapshots(_snapshot_of(resumed),
                                _snapshot_of(straight))

    def test_variables_win_over_the_conf(self, tmp_path, monkeypatch):
        """A ``TONY_CKPT_*`` variable names its setting; the conf fills
        only what no variable names."""
        path = tmp_path / "tony-job.json"
        path.write_text(json.dumps({"tony.ckpt.dir": str(tmp_path / "conf"),
                                    "tony.ckpt.every": "1"}))
        monkeypatch.setenv(constants.ENV_CONF_PATH, str(path))
        monkeypatch.setenv(constants.ENV_CKPT_DIR, str(tmp_path / "env"))
        batch = _torch_batch(_mlp_batch())
        ttrain.train_loop(_port_state("mlp_sgd"), _MLP_STEP, [batch] * 2)
        assert fmt.committed_steps(tmp_path / "env") == [1, 2]
        assert not (tmp_path / "conf").exists()

    def test_restore_on_start_false_ignores_checkpoint(self, tmp_path):
        batch = _torch_batch(_mlp_batch())
        ttrain.train_loop(_port_state("mlp_momentum"), _MLP_STEP,
                          [batch] * 2, ckpt_dir=str(tmp_path), save_every=1)
        final, _ = ttrain.train_loop(_port_state("mlp_momentum", seed=2),
                                     _MLP_STEP, [batch],
                                     ckpt_dir=str(tmp_path),
                                     restore_on_start=False,
                                     save_final=False)
        assert final.step == 1


@pytest.mark.usefixtures("clean_train_env")
@pytest.mark.parametrize("case", ["cnn", "resnet_plain", "resnet_fused"])
def test_killed_and_resumed_equals_uninterrupted(tmp_path, case):
    """mnist-cnn and resnet18-thin on both lanes: a run saved at step 2
    and killed after step 3, resumed from other weights to step 4, is
    ``torch.equal`` to an uninterrupted run in every parameter, running
    statistic and trace."""
    batches = [_torch_batch(CASES[case][3](seed=i)) for i in range(4)]
    step = _port_step(case)

    def kill(i, metrics):
        if i == 3:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        ttrain.train_loop(_port_state(case), step, batches,
                          ckpt_dir=str(tmp_path), save_every=2,
                          on_step=kill)
    assert fmt.committed_steps(tmp_path) == [2]
    resumed, _ = ttrain.train_loop(_port_state(case, seed=1), step,
                                   batches[2:], ckpt_dir=str(tmp_path),
                                   save_final=False)
    straight, _ = ttrain.train_loop(_port_state(case), step, batches)
    _assert_equal_snapshots(_snapshot_of(resumed), _snapshot_of(straight))


# ---------------------------------------------------------------------------
# Across frameworks
# ---------------------------------------------------------------------------

@flax.struct.dataclass
class ResNetState:
    """The reference's ResNet carry (tony_tpu/benchmark.py:57-96,
    ``(params, opt_state, batch_stats)``) as a train state: a flax
    ``TrainState`` with ``batch_stats``, the form flax nets with
    BatchNorm train in."""
    step: Any
    params: Any
    opt_state: Any
    batch_stats: Any


def _rename_plain(tree):
    """The fused lane's flax paths as the plain lane's."""
    if not isinstance(tree, dict):
        return tree
    return {k.replace("FusedBottleneck", "Bottleneck").replace(
        "FusedBNAct", "BatchNorm"): _rename_plain(v) for k, v in tree.items()}


def _jax_target(case):
    """A JAX template of the case's train state: ``create_train_state``'s
    for the MNIST nets, the ResNet carry for ResNet (zeros of the
    variables' shapes; the fused lane's paths renamed from the plain
    lane's, as the JAX lanes name them)."""
    name, kw, momentum, make, lane = CASES[case]
    tx = optax.sgd(0.1, momentum=momentum)
    x = jnp.asarray(make()["x"])
    if lane is None:
        return jtrain.create_train_state(jget(name, **kw), tx, x,
                                         jax.random.PRNGKey(0))
    # Shapes only (the restore writes every value): no eager init.
    shapes = jax.eval_shape(lambda: jget(name, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), x, train=False))
    variables = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    if lane == "fused":
        variables = _rename_fused(variables)
    return ResNetState(step=0, params=variables["params"],
                       opt_state=tx.init(variables["params"]),
                       batch_stats=variables["batch_stats"])


def _by_port_name(tree, case):
    convert = mlp_params_from_jax if CASES[case][0] == "mnist-mlp" \
        else conv_params_from_jax
    return convert(_np(tree))


def _jax_save(root, tree, step):
    c = jckpt.AsyncCheckpointer(root)
    c.save(tree, step=step, block=True)
    c.close()


def _manifest_set(root, step):
    return {(m["path"], tuple(m["shape"]), m["dtype"])
            for m in fmt.read_manifest(root, step)["leaves"]}


def _jax_one_step(case, back, batch):
    """One reference step from the restored JAX state: the jitted
    ``make_train_step`` for the MNIST nets, the reference ResNet step
    (value_and_grad with the batch stats mutable, optax.sgd,
    apply_updates) on the plain lane's paths for ResNet. Returns the
    loss and the new tree in the port's names."""
    name, kw, momentum, _, lane = CASES[case]
    if lane is None:
        step = jtrain.make_train_step(donate=False)
        new, metrics = step(back, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
        return float(metrics["loss"]), _by_port_name(new.params, case)
    params, stats = _rename_plain(back.params), _rename_plain(
        back.batch_stats)
    loss, _, grads, new_stats = _jax_train_step(
        jget(name, dtype=jnp.float32),
        {"params": params, "batch_stats": stats}, batch["x"], batch["y"])
    tx = optax.sgd(0.1, momentum=momentum)
    opt = jax.tree.map(jnp.asarray, _rename_plain_opt(back.opt_state))
    updates, _ = tx.update(grads, opt, params)
    new = {"params": _np(optax.apply_updates(params, updates)),
           "batch_stats": new_stats}
    if lane == "fused":
        new = _rename_fused(new)
    return loss, conv_params_from_jax(new)


def _rename_plain_opt(opt_state):
    trace = opt_state[0]
    return (type(trace)(trace=_rename_plain(_np(trace.trace))),
            opt_state[1])


@pytest.mark.usefixtures("clean_train_env")
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_written_step_restores_into_jax(tmp_path, case):
    """The port trains two steps through ``train_loop`` and commits; the
    manifest's (path, shape, dtype) set is a JAX save's of the same
    state, JAX ``restore_pytree`` into the JAX template restores every
    parameter, statistic and trace leaf equal to the port's tensors, and
    one more step on each side agrees: loss 1e-5 relative, every
    parameter (and statistic) within 2e-6 (MNIST nets,
    tests/test_torch_train.py) or 1e-4 of its scale (ResNet,
    tests/test_torch_resnet.py)."""
    make, lane = CASES[case][3], CASES[case][4]
    batch = make()
    step = _port_step(case)
    state, _ = ttrain.train_loop(_port_state(case), step,
                                 [_torch_batch(batch)] * 2,
                                 ckpt_dir=str(tmp_path / "p"))
    tmpl = _jax_target(case)
    _jax_save(tmp_path / "j", tmpl, 2)
    assert _manifest_set(tmp_path / "p", 2) == \
        _manifest_set(tmp_path / "j", 2)
    back = jckpt.restore_pytree(tmp_path / "p", tmpl)
    assert int(back.step) == 2
    model = state.model
    got = _by_port_name({"params": back.params, **(
        {"batch_stats": back.batch_stats} if lane else {})}, case)
    own = model.state_dict()
    assert sorted(got) == sorted(own)
    for name, t in own.items():
        assert torch.equal(got[name], t), name
    names = [n for n, _ in model.named_parameters()]
    if CASES[case][2] is None:
        assert jax.tree.leaves(back.opt_state) == []
    else:
        trace = _by_port_name(back.opt_state[0].trace, case)
        for name, t in zip(names, state.opt_state.trace):
            assert torch.equal(trace[name], t), name

    jloss, ref = _jax_one_step(case, back, batch)
    state, metrics = step(state, _torch_batch(batch))
    assert float(metrics["loss"]) == pytest.approx(jloss, rel=1e-5)
    for name, t in model.state_dict().items():
        a, b = t.numpy(), ref[name].numpy()
        bar = 2e-6 if lane is None else 1e-4 * max(np.abs(b).max(), 1.0)
        assert np.abs(a - b).max() <= bar, name


@pytest.mark.usefixtures("clean_train_env")
def test_jax_written_step_restores_into_the_port(tmp_path):
    """JAX's ``train_loop`` trains mnist-mlp two steps with
    ``optax.sgd(0.1, momentum=0.9)`` and commits; the port's restore
    fills parameters and trace bit for bit, ``load_jax_params(state=)``
    reads the same trace and step, and one more step on each side (the
    port's from its ``train_loop``, which resumes from the JAX step)
    agrees within tests/test_torch_train.py's limits (loss 1e-5
    relative, parameters 2e-6)."""
    batch = _mlp_batch()
    js = _jax_target("mlp_momentum")
    jstep = jtrain.make_train_step(donate=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    js, _ = jtrain.train_loop(js, jstep, [jbatch] * 2,
                              ckpt_dir=str(tmp_path))
    assert jckpt.latest_step(tmp_path) == 2
    state = ckpt.decode_portable(ckpt.restore_pytree(
        tmp_path, ckpt.encode_portable(_port_state("mlp_momentum",
                                                   seed=5))))
    assert state.step == 2
    params = mlp_params_from_jax(_np(js.params))
    trace = mlp_params_from_jax(_np(js.opt_state[0].trace))
    names = [n for n, _ in state.model.named_parameters()]
    for name, p in state.model.named_parameters():
        assert torch.equal(p, params[name]), name
    for name, t in zip(names, state.opt_state.trace):
        assert torch.equal(t, trace[name]), name
    other = _port_state("mlp_momentum", seed=6)
    load_jax_params(other.model, _np(js), state=other)
    assert other.step == 2
    _assert_equal_snapshots(_snapshot_of(other), _snapshot_of(state))

    js3, jm = jstep(js, jbatch)
    fresh, m = ttrain.train_loop(_port_state("mlp_momentum", seed=7),
                                 _MLP_STEP, [_torch_batch(batch)],
                                 ckpt_dir=str(tmp_path), save_final=False)
    assert fresh.step == 3
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    ref = mlp_params_from_jax(_np(js3.params))
    for name, p in fresh.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   atol=2e-6, rtol=0, err_msg=name)


def test_sgd_without_momentum_loads_from_jax():
    """``load_jax_params(state=)`` of a JAX ``optax.sgd(0.1)`` state
    (two empty states) sets the step and leaves the port's trace-less
    state as it is."""
    js = _jax_target("mlp_sgd").replace(step=5)
    state = _port_state("mlp_sgd", seed=3)
    load_jax_params(state.model, _np(js), state=state)
    assert state.step == 5 and state.opt_state.trace is None
    params = mlp_params_from_jax(_np(js.params))
    for name, p in state.model.named_parameters():
        assert torch.equal(p, params[name]), name


def test_zero3_trace_follows_the_adamw_slots():
    """On a ZeRO-3 state every per-leaf slot carries its parameter's
    layout (``create_train_state`` attaches it): SGD's trace encodes as
    the same sharded leaf views as AdamW's ``mu`` (paths, global shapes,
    specs, replicas, part offsets), so a rank writes its own shard of
    the trace as it writes its moments. (The layouts are attached by
    hand here, as rank 1 of fsdp 2 holding the second half of each
    matrix's dim 0; no process group is needed to encode.)"""
    from tony_tpu_torch.parallel.layout import Layout, set_layout

    def encoded(tx):
        model = get_model("llama-tiny", device="cpu", dtype=torch.float32)
        state = ttrain.create_train_state(model, tx)
        params = list(model.parameters())
        for p in params:
            if p.dim() == 2:
                set_layout(p, Layout(shape=(2 * p.shape[0], p.shape[1]),
                                     spec=("fsdp", None), dim=0,
                                     start=p.shape[0]))
        ttrain._attach_slot_layouts(state.opt_state, params)
        return ckpt.encode_portable(state).opt_state[0]

    def geometry(tree):
        paths, leaves, _ = snapshot.leaf_paths(tree)
        return [(path, leaf.shape, leaf.spec, leaf.replica,
                 [(start, tuple(t.shape), perm)
                  for start, t, perm in leaf.parts])
                for path, leaf in zip(paths, leaves)
                if isinstance(leaf, LeafView)]

    mu = geometry(encoded(ttrain.adamw(1e-3)).mu)
    trace = geometry(encoded(ttrain.sgd(0.1, momentum=0.9)).trace)
    assert trace == mu
    assert any(spec and "fsdp" in spec for _, _, spec, _, _ in trace)


# ---------------------------------------------------------------------------
# Permuted views and staging in pieces
# ---------------------------------------------------------------------------

def test_permuted_view_of_a_channels_last_tensor(tmp_path):
    """An OIHW weight in channels-last memory, viewed as flax's HWIO
    kernel: the saved chunk is the permuted values (JAX reads them), and
    the restore writes them back through the same view into another
    channels-last tensor, which keeps its layout."""
    w = torch.randn(8, 3, 3, 5, generator=torch.Generator().manual_seed(0))
    w = w.to(memory_format=torch.channels_last)
    assert not w.is_contiguous()
    view = LeafView.of(w, perm=(2, 3, 1, 0))
    assert view.shape == (3, 5, 3, 8)
    c = ckpt.AsyncCheckpointer(tmp_path)
    c.save({"kernel": view}, step=1, block=True)
    c.close()
    hwio = w.permute(2, 3, 1, 0).numpy()
    back = jckpt.restore_pytree(tmp_path, {"kernel": np.zeros((3, 5, 3, 8),
                                                              np.float32)})
    np.testing.assert_array_equal(np.asarray(back["kernel"]), hwio)
    out = torch.zeros_like(w)       # preserves channels-last strides
    ckpt.restore_pytree(tmp_path, {"kernel": LeafView.of(out,
                                                         perm=(2, 3, 1, 0))})
    assert torch.equal(out, w)
    assert out.is_contiguous(memory_format=torch.channels_last)


def test_piece_planner():
    """Chunks in order, 256-byte aligned, into pieces of a buffer of the
    budget or of the largest chunk where that is larger."""
    cap, pieces = snapshot.plan_pieces([100, 300, 1000, 50, 50], 512)
    assert cap == 1024 and pieces == [[0, 1], [2], [3, 4]]
    cap, pieces = snapshot.plan_pieces([256] * 5, 600)
    assert cap == 600 and pieces == [[0, 1], [2, 3], [4]]
    cap, pieces = snapshot.plan_pieces([10, 20], 1 << 30)
    assert cap == 1 << 30 and pieces == [[0, 1]]
    sizes = list(np.random.default_rng(0).integers(1, 5000, 40))
    cap, pieces = snapshot.plan_pieces(sizes, 4096)
    assert [i for p in pieces for i in p] == list(range(40))
    assert all(sum(-(-sizes[i] // 256) * 256 for i in p) <= cap
               for p in pieces)


# ---------------------------------------------------------------------------
# The gang restart of a --framework pytorch job
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_checkpoint_resume_across_gang_restart(tmp_path, monkeypatch):
    """tests/test_e2e.py's gang-restart resume with ``--framework
    pytorch`` and ``tests/workloads/torch_train_resume.py``: attempt 1
    trains and commits through ``train_loop``, dies; the gang restarts;
    attempt 2 resumes from the directory ``tony.ckpt.dir`` names in the
    job conf (no variable carries it), and the AM logs the committed
    step the executor's heartbeat reported."""
    from tony_tpu.am import ApplicationMaster
    from tony_tpu.minipod import MiniPod

    logged = []
    monkeypatch.setattr(ApplicationMaster, "_log",
                        lambda self, msg: logged.append(msg))
    ckpt_dir = tmp_path / "ckpt"
    job = MiniPod(tmp_path / "pod").run({
        "tony.application.framework": "pytorch",
        "tony.worker.instances": "1",
        "tony.application.executes": "python torch_train_resume.py",
        "tony.ckpt.dir": str(ckpt_dir),
        "tony.am.retry-count": "1",
        "tony.task.max-missed-heartbeats": "100",
    }, src_dir=WORKLOADS, timeout=180)
    assert job.exit_code == 0, job.session.final_message
    assert job.session.attempt_id == 2
    results = list(Path(job.am.job_dir).glob(
        "containers/*/src/resume.json"))
    assert len(results) == 1
    data = json.loads(results[0].read_text())
    assert data["resumed_from"] == 3
    assert data["final_step"] == 5
    assert fmt.committed_steps(ckpt_dir)[-1] == 5
    assert any("attempt 1 failed; gang restart" in msg and
               msg.endswith("resuming from committed ckpt step 3")
               for msg in logged), logged
