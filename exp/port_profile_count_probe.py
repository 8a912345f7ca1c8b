"""Does the profiler see every flash-attention launch? Profiles windows
of the bf16 packed forward and backward launches (the 7B train step's
shapes, b=2 t=2048 h=32 d=128, causal) and counts the kernel events
``torch.profiler`` reports against the launches the wrappers counted,
with the wrappers as they are, with their device switch made a no-op,
and with a warm-up step in the profiler's schedule before the counted
one.
Run from the repository root on a machine with one GPU::

    python3 exp/port_profile_count_probe.py
"""

import ctypes
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from tony_tpu_torch.ops import LAUNCHES  # noqa: E402
from tony_tpu_torch.ops import attention as attn  # noqa: E402


def window(q, k, v, do, launches, warmup=False):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def run():
        for _ in range(launches):
            o, lse = attn._flash_fwd_cuda(q, k, v, True, 128 ** -0.5)
            attn._flash_bwd_cuda(q, k, v, o, lse, do, True, 128 ** -0.5)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    sched = (torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
             if warmup else None)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        if warmup:
            run()
            prof.step()
            before = dict(LAUNCHES)
        run()
        if warmup:
            prof.step()
    seen = {}
    for e in prof.key_averages():
        name = re.search(r"flash_\w+_kernel", e.key)
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA \
                and name:
            seen[name.group(0)] = seen.get(name.group(0), 0) + e.count
    counted = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES
               if LAUNCHES[k] != before.get(k, 0)}
    return seen, counted


def launch_on_current_device(lib, fn_name, counter, args, dims, tensors):
    """The wrappers' launch without the switch to the tensors' device."""
    strides = (ctypes.c_int64 * (4 * len(tensors)))(
        *[s for x in tensors for s in x.stride()])
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = getattr(lib, fn_name)(*args, *dims, strides, stream)
    if rc != 0:
        raise RuntimeError(f"{counter} kernel launch failed: {rc}")
    LAUNCHES[counter] += 1


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    g = torch.Generator(device="cuda").manual_seed(0)

    def make():
        x = torch.randn((2, 2048, 32 * 128), generator=g, device="cuda")
        return x.to(torch.bfloat16).unflatten(2, (32, 128)).transpose(1, 2)

    q, k, v, do = make(), make(), make(), make()
    out = {}
    for mode in ("as is", "no device switch", "warmup step", "as is",
                 "no device switch", "warmup step"):
        saved = attn._launch
        if mode == "no device switch":
            attn._launch = launch_on_current_device
        try:
            rows = [window(q, k, v, do, 8, warmup=mode == "warmup step")
                    for _ in range(10)]
        finally:
            attn._launch = saved
        short = [r for r in rows if any(r[0].get(n, 0) != 8 for n in (
            "flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
            "flash_bwd_dkv_mma_kernel"))]
        out.setdefault(mode, []).append({"windows": len(rows),
                                         "short": len(short),
                                         "short_seen": [r[0] for r in short]})
        print(mode, json.dumps(out[mode][-1]), file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
