"""A job end to end through the port's own control plane, held against
the same workload through the JAX package's: ``tests/workloads/
torch_job_train.py`` at two gloo ranks, launched by the port's MiniPod
(its AM, scheduler and executor) with ``tony.worker.gpus=1`` under
``tony.scheduler.total-gpus=2``, and by the JAX MiniPod without the ask
(the JAX conf refuses GPU asks). The port's job succeeds, each task is
pinned to its own card, neither its executor nor its user process
imports the JAX package, and its final parameters equal the JAX-launched
job's."""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch

from tony_tpu.minipod import MiniPod as JMiniPod
from tony_tpu_torch.minipod import MiniPod

WORKLOADS = Path(__file__).resolve().parent / "workloads"
_FORBIDDEN_IMPORT = re.compile(r"^import '(jax|jaxlib|flax|optax|tony_tpu)"
                               r"['.]", re.M)


def _results(job_dir: Path):
    out = [json.loads(p.read_text())
           for p in job_dir.rglob("job_result.json")]
    return sorted(out, key=lambda r: r["rank"])


def test_two_rank_job_pinned_and_equal_to_the_jax_minipod(tmp_path,
                                                          monkeypatch):
    data = tmp_path / "tokens.npy"
    np.save(data, np.random.default_rng(0).integers(0, 256, (16, 16))
            .astype(np.int32))
    cmd = (f"python torch_job_train.py --model llama-tiny --steps 3 "
           f"--data {data} --batch 4 --device cpu --dtype float32 "
           f"--xent-chunk 8 --lr 1e-2 --final-params")
    common = {"tony.application.framework": "pytorch",
              "tony.worker.instances": "2",
              "tony.application.executes": cmd}
    # The executor runs verbose (its log lists every module it imports);
    # the user process is set back to quiet through the task env.
    monkeypatch.setenv("PYTHONVERBOSE", "1")
    port = MiniPod(tmp_path / "port").run(
        {**common, "tony.worker.gpus": "1", "tony.scheduler.total-gpus": "2",
         "tony.data.seed": "0", "tony.worker.env": "PYTHONVERBOSE="},
        src_dir=WORKLOADS, timeout=180)
    monkeypatch.delenv("PYTHONVERBOSE")
    assert port.exit_code == 0, [
        (t.task_id, t.status.value, t.diagnostics) for t in port.session]
    assert port.scheduler.total_gpus == 2
    assert port.scheduler.gpus_in_use == 0          # released on exit
    job_dir = port.am.job_dir
    results = _results(job_dir)
    assert [(r["rank"], r["visible"], r["task_gpus"]) for r in results] == \
        [(0, "0", "1"), (1, "1", "1")]
    for r in results:
        assert r["world"] == 2 and r["final_step"] == 3
        assert not {"jax", "jaxlib", "flax", "optax", "tony_tpu"} & \
            set(r["modules"]), r["modules"]
        assert all(np.isfinite(r["losses"]))
    logs = sorted(job_dir.rglob("executor.log"))
    assert len(logs) == 2
    for log in logs:
        text = log.read_text()
        assert "import 'tony_tpu_torch.executor'" in text
        assert not _FORBIDDEN_IMPORT.search(text)
        assert "import 'torch'" not in text

    ref = JMiniPod(tmp_path / "jax").run(common, src_dir=WORKLOADS,
                                         timeout=180)
    assert ref.exit_code == 0
    ref_results = _results(ref.am.job_dir)
    assert [r["visible"] for r in ref_results] == [None, None]
    assert [r["losses"] for r in ref_results] == \
        [r["losses"] for r in results]
    ours = torch.load(next(job_dir.rglob("final_params.pt")))
    theirs = torch.load(next(ref.am.job_dir.rglob("final_params.pt")))
    assert ours.keys() == theirs.keys()
    for name in ours:
        assert torch.equal(ours[name], theirs[name]), name
