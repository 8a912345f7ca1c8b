"""Host I/O rates of the machine that holds the card, for sizing the
checkpoint plane: CRC32 and byte-copy rates of numpy buffers, an 8 GiB
write + fsync and read back under the repository's ``build/``, pinned
host memory allocation, pinned device→host and host→device copies, and
the device's transposed vs straight copy of a 7B ``w_gate`` weight.
Run from the repository root on a machine with one GPU::

    python3 exp/port_host_io_probe.py

Prints one line per rate, and the card's name and power limit.
"""

import os
import shutil
import subprocess
import sys
import time
import zlib

import numpy as np
import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    with open("/proc/meminfo") as f:
        print([line.strip() for line in f if line.startswith("MemAvail")])
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "build")
    os.makedirs(root, exist_ok=True)
    print("cpus", os.cpu_count(), "disk free", shutil.disk_usage(root).free)
    buf = np.random.default_rng(0).integers(0, 255, 1 << 30, dtype=np.uint8)
    t = time.perf_counter()
    zlib.crc32(buf)
    print("crc32 GB/s", buf.nbytes / 1e9 / (time.perf_counter() - t))
    t = time.perf_counter()
    buf.tobytes()
    print("tobytes GB/s", buf.nbytes / 1e9 / (time.perf_counter() - t))
    path = os.path.join(root, "probe.bin")
    try:
        t = time.perf_counter()
        with open(path, "wb") as f:
            for _ in range(8):
                f.write(buf)
            f.flush()
            os.fsync(f.fileno())
        print("write+fsync 8 GiB GB/s",
              8 * buf.nbytes / 1e9 / (time.perf_counter() - t))
        t = time.perf_counter()
        n = 0
        with open(path, "rb") as f:
            while True:
                x = f.read(1 << 28)
                if not x:
                    break
                n += len(x)
        print("read GB/s", n / 1e9 / (time.perf_counter() - t))
    finally:
        os.remove(path)
    t = time.perf_counter()
    pinned = [torch.empty(1 << 30, dtype=torch.uint8, pin_memory=True)
              for _ in range(8)]
    print("pin 8 GiB s", time.perf_counter() - t)
    dev = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    for _ in range(2):
        t = time.perf_counter()
        for q in pinned:
            q.copy_(dev, non_blocking=True)
        torch.cuda.synchronize()
        print("d2h pinned GB/s", 8 * dev.numel() / 1e9
              / (time.perf_counter() - t))
        t = time.perf_counter()
        for q in pinned:
            dev.copy_(q, non_blocking=True)
        torch.cuda.synchronize()
        print("h2d pinned GB/s", 8 * dev.numel() / 1e9
              / (time.perf_counter() - t))
    w = torch.randn(11008, 4096, device="cuda")
    o = torch.empty(4096, 11008, device="cuda")
    o.copy_(w.t())
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        o.copy_(w.t())
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 10
    print("transposed copy ms", ms, "GB/s", 2 * w.numel() * 4 / ms / 1e6)
    start.record()
    for _ in range(10):
        o.view(-1).copy_(w.view(-1))
    end.record()
    torch.cuda.synchronize()
    print("straight copy ms", start.elapsed_time(end) / 10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
