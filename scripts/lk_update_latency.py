#!/usr/bin/env python3
"""Latency of one LK update on the card, for each instance of the level kernel.

    python3 scripts/lk_update_latency.py

Builds ``visual_odom_tpu_torch/csrc/lk_legs.cu`` a second time, into the
git-ignored ``visual_odom_tpu_torch/_build/``, with the update's stop test
removed, so that every live feature runs exactly ``max_iters`` updates.
Then it times ``lk_level_kernel`` at level 0 of a 1241x376 synthetic
texture against its copy shifted by (-20, +1) px, 384 features seeded
within a few px, at 1 and at 30 updates, for each instance (doublestep x
packed). The difference over 29 is the time of one dependent update; the
launch at 1 update is the launch, the template setup and one update.
Device times: CUDA events around 20 launches queued behind a sleep kernel,
median of 5 rounds. Needs a CUDA card and nvcc; prints the card, then one
JSON line per instance.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STOP = "const bool stop = converged | flip | !in_b;"
INSTANCES = ((False, False), (True, False), (False, True), (True, True))
SLEEP_CYCLES = 50_000_000


def build_without_stop(nvcc):
    """The kernels' library with the update's stop test removed."""
    with open(os.path.join(nvcc.CSRC, "lk_legs.cu")) as f:
        src = f.read()
    if src.count(STOP) != 1:
        raise RuntimeError("lk_legs.cu no longer has the stop test this "
                           "script removes")
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    cu = os.path.join(nvcc.BUILD_DIR, "lk_legs_nostop.cu")
    lib = os.path.join(nvcc.BUILD_DIR, "liblk_legs_nostop.so")
    with open(cu, "w") as f:
        f.write(src.replace(STOP, "const bool stop = false;"))
    subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", lib, cu],
                   check=True, capture_output=True, text=True)
    return lib


def device_ms(fn, calls=20, rounds=5, warm=3):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lk_update_latency: needs a CUDA device", file=sys.stderr)
        return 2
    from visual_odom_tpu_torch.ops import _nvcc, lk_cuda
    from visual_odom_tpu_torch.ops.lk import LKParams, prepare_lk_image

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    real = lk_cuda._library()
    lib = ctypes.CDLL(build_without_stop(_nvcc))
    for name in ("lk_quad_launch", "lk_level_launch", "lk_kernel_info"):
        getattr(lib, name).argtypes = getattr(real, name).argtypes
        getattr(lib, name).restype = ctypes.c_int
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (376, 1241))
    for _ in range(3):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5
    img = ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.float32)
    shifted = np.roll(np.roll(img, 1, 0), -20, 1)
    li = prepare_lk_image(torch.tensor(img, device=dev))
    lj = prepare_lk_image(torch.tensor(shifted, device=dev))
    n, half = 384, 10.0
    pts = torch.tensor(np.stack([rng.uniform(30, 1200, n),
                                 rng.uniform(30, 340, n)], -1),
                       dtype=torch.float32, device=dev)
    disp = torch.tensor(np.stack([rng.uniform(-23, -17, n),
                                  rng.uniform(-1, 3, n)], -1),
                        dtype=torch.float32, device=dev)
    prev = (pts - half).contiguous()
    init = (pts + disp - half).contiguous()
    mask = torch.ones(n, dtype=torch.int32, device=dev)
    rows, cols = li.shapes[0]
    saved = lk_cuda._library
    lk_cuda._library = lambda: lib
    try:
        for inst in INSTANCES:
            us = {}
            for k in (1, 30):
                params = LKParams(max_iters=k)
                us[k] = 1e3 * device_ms(lambda: lk_cuda.lk_level_cuda(
                    li.pyramid[0], lj.pyramid[0], rows, cols, li.pad, prev,
                    init, mask, params, True, doublestep=inst[0],
                    packed=inst[1]))
            print(json.dumps({
                "kernel": "lk_level_kernel", "doublestep": inst[0],
                "packed": inst[1], "us_at_1_update": us[1],
                "us_at_30_updates": us[30],
                "us_per_update": (us[30] - us[1]) / 29}))
    finally:
        lk_cuda._library = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
