"""Wall time of several test processes at once against torch's
intra-op thread count: ``--procs`` copies of one pytest selection run
together with ``OMP_NUM_THREADS`` set to each of ``--threads``, one
count after another (the setting ``tests/test_torch_threads.py``
pins). Run from the repository root::

    python3 exp/port_test_threads.py [--procs 6] [--threads 1,2,8] \\
        [--select "tests/test_torch_spec.py -k depth_sweep and f32"]

Prints one JSON line: the wall seconds for each thread count.
"""

import argparse
import json
import os
import shlex
import subprocess
import sys
import time


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--procs", type=int, default=6)
    p.add_argument("--threads", default="1,2,8")
    p.add_argument("--select",
                   default="tests/test_torch_spec.py -k 'depth_sweep and f32'")
    args = p.parse_args()
    out = {}
    for t in [int(x) for x in args.threads.split(",")]:
        env = dict(os.environ, OMP_NUM_THREADS=str(t), JAX_PLATFORMS="cpu")
        cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
               "-p", "no:randomly", *shlex.split(args.select)]
        t0 = time.monotonic()
        procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL)
                 for _ in range(args.procs)]
        codes = [proc.wait() for proc in procs]
        out[t] = {"wall_s": round(time.monotonic() - t0, 1),
                  "exit_codes": codes}
        print(f"threads {t}: {out[t]}", file=sys.stderr, flush=True)
    print(json.dumps({"procs": args.procs, "select": args.select,
                      "cpus": os.cpu_count(), "by_threads": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
