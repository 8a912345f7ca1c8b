"""How far apart sound f32 ResNet-50 grads fall, against faulty controls.

``chip_smoke.py`` holds one f32 ResNet-50 train step (batch 32,
deterministic cuDNN) through the fused BN kernels against the plain
versions on the card and against the plain BN lane. Two valid f32
summation orders of the BN sums flip ReLU masks where a pre-activation
is within rounding of 0, so the grads of sound runs differ; this script
measures by how much, and how far two deliberately faulty versions
stand, so that the limits sit between the two.

For each seed (weights from ``get_model(seed=...)``, images from
``numpy.random.default_rng(seed)``) and each state (flax's init, where
every block's exit BN scale is 0, and the same weights with exit scales
1), one step runs six ways:

* ``kernels`` — the hand-written kernels;
* ``plain`` — their plain versions on the card;
* ``f64`` — the plain versions with both reductions accumulated in f64
  and rounded once (the most accurate summation order);
* ``lane`` — the plain BN lane (``fused_bn=False``);
* ``control_bf16_sums`` — the kernels with every sum rounded to bf16 (a
  kernel that accumulates in its input's precision);
* ``control_mask`` — the backward's ReLU mask taken without the residual
  (the bug the add variant's recomputed mask guards against).

Every pair prints the loss's relative difference, the new running
statistics' max |Δ| / max(|ref|, 1), and three grad measures: the max
over parameters of ||Δ|| / ||g||_all (the norm of the whole grad;
``chip_smoke.grad_err``), and the per-parameter relative L2 split into
conv/Dense weights and BN scales/biases. The last line is the summary:
each measure's largest reading over sound pairs (among kernels, plain
and f64; and those against the lane) and smallest over control pairs.

    python exp/port_resnet_grad_noise.py [--seeds 4] [--batch 32]

Needs one NVIDIA GPU. Prints one JSON line per seed and state, then the
card's ``nvidia-smi`` name and power limit, then the summary.
"""

import argparse
import itertools
import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from tony_tpu_torch.models import get_model  # noqa: E402
from tony_tpu_torch.ops import batchnorm as bn  # noqa: E402

SOUND = ("kernels", "plain", "f64", "lane")
CONTROLS = ("control_bf16_sums", "control_mask")


def _stats_f64(x2d):
    xd = x2d.double()
    return torch.stack([xd.sum(0), (xd * xd).sum(0)]).float()


def _bwd_reduce_f64(dy, x2d, mean, var, gamma, beta, res2d, eps, relu):
    pre, xhat, _ = bn._pre_act(x2d, mean, var, gamma, beta, eps)
    g = bn._masked_grad(dy, pre, res2d, relu).double()
    return torch.stack([g.sum(0), (g * xhat.double()).sum(0)]).float()


def _bf16_rounded(fn):
    return lambda *a: fn(*a).bfloat16().float()


def _reduce_mask_without_residual(dy, x2d, mean, var, gamma, beta, res2d,
                                  eps, relu):
    return bn._bwd_reduce_plain(dy, x2d, mean, var, gamma, beta, None, eps,
                                relu)


def _dx_mask_without_residual(dy, x2d, mean, var, gamma, beta, red, res2d,
                              eps, relu, minv):
    dx, _ = bn._bwd_dx_plain(dy, x2d, mean, var, gamma, beta, red, None, eps,
                             relu, minv)
    if res2d is None:
        return dx, None
    pre, _, _ = bn._pre_act(x2d, mean, var, gamma, beta, eps)
    return dx, bn._masked_grad(dy, pre, None, relu).to(res2d.dtype)


def swaps():
    """Each fused-lane run's wrapper swaps (none: the kernels)."""
    return {
        "kernels": {},
        "plain": dict(_stats_cuda=bn._stats_plain,
                      _apply_cuda=bn._apply_plain,
                      _bwd_reduce_cuda=bn._bwd_reduce_plain,
                      _bwd_dx_cuda=bn._bwd_dx_plain),
        "f64": dict(_stats_cuda=_stats_f64, _apply_cuda=bn._apply_plain,
                    _bwd_reduce_cuda=_bwd_reduce_f64,
                    _bwd_dx_cuda=bn._bwd_dx_plain),
        "control_bf16_sums": dict(
            _stats_cuda=_bf16_rounded(bn._stats_cuda),
            _bwd_reduce_cuda=_bf16_rounded(bn._bwd_reduce_cuda)),
        "control_mask": dict(_bwd_reduce_cuda=_reduce_mask_without_residual,
                             _bwd_dx_cuda=_dx_mask_without_residual),
    }


def rel_l2_split(a, b):
    """Max per-parameter relative L2 over conv/Dense weights and over BN
    scales/biases (0 where both grads are exactly zero)."""
    out = {"weights": 0.0, "bn": 0.0}
    for name, gb in b.items():
        diff = float((a[name] - gb).norm())
        ref = float(gb.norm())
        rel = 0.0 if diff == 0.0 else diff / ref if ref else math.inf
        kind = "bn" if ("FusedBNAct" in name or name.startswith("stem_bn")
                        or "proj_bn" in name) else "weights"
        out[kind] = max(out[kind], rel)
    return out


def compare(a, b):
    err = cs.grad_err(a[1], b[1])
    worst = max(err, key=err.get)
    split = rel_l2_split(a[1], b[1])
    return {"grads_max_err": err[worst], "worst_param": worst,
            "rel_l2_weights": split["weights"], "rel_l2_bn": split["bn"],
            "stats_max_rel": cs.stats_rel(a[2], b[2]),
            "loss_rel": abs(a[0] - b[0]) / abs(b[0])}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    readings = []
    for seed in range(args.seeds):
        init = {n: t.detach().clone() for n, t in get_model(
            "resnet50", device="cuda", fused_bn=True, s2d_stem=True,
            seed=seed).state_dict().items()}
        (fused, plain), x, y = cs.check_models(args.batch, seed)
        for label, state in (("init", init),
                             ("unit_exit_scale", cs.unit_exit_scale(init))):
            runs = {}
            with cs.deterministic_cudnn():
                for name, attrs in swaps().items():
                    with cs.swapped(bn, **attrs):
                        runs[name] = cs.resnet_step_outputs(fused, state, x,
                                                            y)
                runs["lane"] = cs.resnet_step_outputs(plain, state, x, y)
            pairs = {f"{a}-{b}": compare(runs[a], runs[b])
                     for a, b in itertools.combinations(SOUND, 2)}
            pairs.update({f"{c}-{s}": compare(runs[c], runs[s])
                          for c in CONTROLS for s in SOUND})
            reading = {"seed": seed, "state": label, "loss": runs["kernels"][0],
                       "pairs": pairs}
            readings.append(reading)
            print(json.dumps(reading), flush=True)
            del runs
        del fused, plain
        torch.cuda.empty_cache()
    measures = ("grads_max_err", "rel_l2_weights", "rel_l2_bn",
                "stats_max_rel", "loss_rel")
    groups = {
        "sound_kernels_plain_f64": lambda p: "lane" not in p
        and "control" not in p,
        "sound_with_lane": lambda p: "lane" in p and "control" not in p,
        "control_bf16_sums": lambda p: p.startswith("control_bf16_sums"),
        "control_mask": lambda p: p.startswith("control_mask"),
    }
    summary = {}
    for group, member in groups.items():
        vals = [r["pairs"][p] for r in readings for p in r["pairs"]
                if member(p)]
        pick = min if group.startswith("control") else max
        summary[group] = {m: pick(v[m] for v in vals) for m in measures}
        summary[group]["of"] = "min" if pick is min else "max"
    print(card, flush=True)
    print(json.dumps({"card": card, "seeds": args.seeds, "batch": args.batch,
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
