"""Readings the correctness limits are set from, in one process on a card.

    python3 -m vobench.calibrate --workload <cell> --seeds <n> [<n> ...] \\
        [--control <k>] [--out <file.jsonl>] [--gaps <dir>]

For each seed, one job of the cell at its own size (the window's first
job for that seed) and the reference over every clip of it: the
comparison's numbers of a sound run (``"kind": "sound"``). For the
first ``--control`` seeds, the control as well: the reference computed in
the nearest precision below the configuration's float32 with TF32 off,
that is with TF32 on for matmuls and cuDNN, put in the program's place
and held to the reference (``"kind": "control"``). A limit lies above the
largest sound reading and below the smallest control reading. With
``--gaps <dir>`` each reading's per-frame gaps (``check.frame_gaps``) and
accepts are kept as ``<dir>/<cell>.<seed>.<kind>.npz``, from which other
numbers can be read without a card. Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


@contextlib.contextmanager
def tf32():
    """TF32 on for matmuls and cuDNN convolutions, restored after."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def control_job(job, out):
    """``job`` with its clips' outputs replaced by the control's ``out``:
    the reference in lower precision, in the program's place."""
    from vobench.reference.step import chain_poses

    accept = [out.accept[:, b].astype(bool) for b in range(len(job.starts))]
    return job._replace(
        poses=[chain_poses(out.T_inv[:, b], a) for b, a in enumerate(accept)],
        accept=accept,
        mean_inliers=[float(out.num_inliers[:, b].mean())
                      for b in range(len(job.starts))])


def _keep_gaps(gaps_dir, cell, seed, kind, job, ref) -> None:
    import os

    import numpy as np

    from vobench import check

    if not gaps_dir:
        return
    os.makedirs(gaps_dir, exist_ok=True)
    t, r = check.frame_gaps(job, ref)
    np.savez(os.path.join(gaps_dir, f"{cell}.{seed}.{kind}.npz"), t=t, r=r,
             accept=np.stack([np.asarray(a, bool) for a in job.accept]),
             ref_accept=ref.accept.T.astype(bool))


def readings(cell, seeds, control: int, device="cuda", bank=None,
             program=None, out=sys.stdout, gaps_dir=""):
    from vobench import check
    from vobench.run import setup

    door, bank, ref_cfg, ref_intr, _ = setup(cell, device, bank, program)
    door.warm(seeds[0])
    frames = cell.traffic["clip_frames"]
    for k, seed in enumerate(seeds):
        job = door.job(seed, 0, traced=False)
        t = time.perf_counter()
        ref, _ = check.reference_run(job, bank, ref_cfg, ref_intr, frames,
                                     device)
        line = {"cell": cell.name, "seed": seed, "kind": "sound",
                "job_s": job.t1 - job.t0,
                "reference_s": time.perf_counter() - t,
                **check.compare(job, ref)}
        print(json.dumps(line), file=out, flush=True)
        _keep_gaps(gaps_dir, cell.name, seed, "sound", job, ref)
        if k < control:
            with tf32():
                low, _ = check.reference_run(job, bank, ref_cfg, ref_intr,
                                             frames, device)
            ctl = control_job(job, low)
            print(json.dumps({"cell": cell.name, "seed": seed,
                              "kind": "control",
                              **check.compare(ctl, ref)}),
                  file=out, flush=True)
            _keep_gaps(gaps_dir, cell.name, seed, "control", ctl, ref)


def main(argv=None) -> int:
    from vobench import spec
    from vobench.run import _set_environment

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--out", default="")
    p.add_argument("--gaps", default="")
    args = p.parse_args(argv)
    _set_environment()
    cell = spec.load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    with (open(args.out, "a") if args.out else contextlib.nullcontext(
            sys.stdout)) as out:
        readings(cell, args.seeds, args.control, out=out,
                 gaps_dir=args.gaps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
