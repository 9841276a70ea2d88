#!/usr/bin/env python3
"""Probe NCCL ranks replaying CUDA graphs in a world of several ranks, one
rank per card.

    python3 scripts/nccl_graph_probe.py [--world 2] [--limit 120]
                                        [--keep-graphs] [--out DIR]

Builds the LK kernels, then spawns ``--world`` ranks, rank r on card r,
each running ``tests/torch_dist_worker.py``'s ``card_graph`` scenario (the
mesh step and scan on both LK routes and the three solvers, eager inside
``utils.cudagraph.dispatch(False)`` and then by default, where every rank
captures and replays its graphs with its NCCL collectives inside them),
then destroying its process group. Each rank logs each capture's warm-up,
capture, collectives and end (the ``cudagraph`` logger at DEBUG), and runs with ``NCCL_DEBUG=INFO`` and
``NCCL_DEBUG_SUBSYS=INIT,COLL``. A rank still running ``--limit`` - 10
seconds after its start prints every thread's Python stack and exits
(``faulthandler``); after ``--limit`` seconds what is left is killed.

Prints each rank's exit code, the tail of its log (whose last lines say
where a stuck rank stood) and, where every rank ended, whether each rank's
graphed run equals its eager run bit for bit (outputs, states, launches)
and whether every rank got the same solver outputs; exits 0 only if every
rank exited 0 and both hold. ``--keep-graphs`` is the diagnostic of a
graph that outlives its group: each rank keeps its graphs through the
teardown (``utils.cudagraph.release`` does nothing) and stands in
``destroy_process_group``, the wait that releasing them prevents. With ``--out DIR`` each rank writes its whole log
there as it runs (``nccl_probe_w<world>[_keep]_rank<r>.log``), so that a
log outlives a probe cut by an outer time limit. Needs ``--world`` cards;
run from the root of a checkout.
"""

from __future__ import annotations

import argparse
import faulthandler
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def rank_main(argv, limit: float, keep_graphs: bool) -> int:
    """One rank: ``torch_dist_worker.main`` on ``argv``, its stacks dumped
    if it runs ``limit`` - 10 s."""
    faulthandler.dump_traceback_later(max(1.0, limit - 10), exit=True)
    if keep_graphs:
        from visual_odom_tpu_torch.utils import cudagraph

        cudagraph.release = lambda groups=None: 0
    import torch_dist_worker

    sys.argv = [torch_dist_worker.__file__] + argv
    return torch_dist_worker.main()


def _equal(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and bool(torch.equal(a, b)))
    return a == b


def _verdict(where: str, world: int) -> dict:
    """Each rank's graphed-vs-eager differences and the solver outputs
    that differ between ranks, from the ranks' saved results."""
    import torch

    ranks = [torch.load(os.path.join(where, f"card_graph-rank{r}.pt"),
                        map_location="cpu", weights_only=False)
             for r in range(world)]
    out = {"graphs_built": [len(r["graphs_built"]) for r in ranks],
           "line_accepts_graph": [r["line_accepts_graph"] for r in ranks],
           "held_before_teardown": [r["held_before_teardown"] for r in ranks],
           "held_after_teardown": [r["held_after_teardown"] for r in ranks],
           "teardown_s": [round(r["teardown_s"], 3) for r in ranks],
           "collectives_differ": _collectives_differ(ranks),
           "graphed_differs": [[p for p in r["graphed"]
                                if not _equal(r["graphed"][p], r["eager"][p])]
                               for r in ranks],
           "ranks_differ": sorted({
               p for r in ranks[1:] for p in r["graphed"]
               if not p.startswith(("step", "scan"))
               and not _equal(r["graphed"][p]["out"],
                              ranks[0]["graphed"][p]["out"])})}
    out["ok"] = (not any(out["graphed_differs"]) and not out["ranks_differ"]
                 and not out["collectives_differ"]
                 and all(out["graphs_built"])
                 and all(out["line_accepts_graph"])
                 and not any(out["held_after_teardown"]))
    return out


def _collectives_differ(ranks) -> list:
    """The paths whose captures issued a group's collectives differently
    (kind, shape, dtype, pairs, order) on two ranks of the group."""
    bad = set()
    for path in ranks[0]["issued"]:
        groups = {}
        for r in ranks:
            mine = {}
            for kind, group, shape, dtype, pairs in r["issued"][path]:
                mine.setdefault(group, []).append((kind, shape, dtype, pairs))
            for group, issued in mine.items():
                groups.setdefault(group, []).append(issued)
        for group, lists in groups.items():
            if len(lists) != len(group) or any(x != lists[0] for x in lists):
                bad.add(path)
    return sorted(bad)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--limit", type=float, default=120.0)
    ap.add_argument("--keep-graphs", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", nargs=5, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank:
        return rank_main(args.rank, args.limit, args.keep_graphs)
    import torch

    if torch.cuda.device_count() < args.world:
        print(f"nccl_graph_probe: needs {args.world} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from visual_odom_tpu_torch.ops import lk_cuda

    lk_cuda._library()          # built here once, so that no rank builds it
    where = tempfile.mkdtemp()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT,
               NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="INIT,COLL")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    tag = "_keep" if args.keep_graphs else ""
    logs = [os.path.join(args.out or where,
                         f"nccl_probe_w{args.world}{tag}_rank{r}.log")
            for r in range(args.world)]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    flags = ["--limit", str(args.limit)] + (["--keep-graphs"]
                                            if args.keep_graphs else [])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *flags, "--rank",
         "card_graph", coordinator, str(args.world), str(r), where], env=env,
        stdout=open(logs[r], "w"), stderr=subprocess.STDOUT)
        for r in range(args.world)]
    t = time.monotonic()
    while (time.monotonic() - t < args.limit
           and any(p.poll() is None for p in procs)):
        time.sleep(1)
    for p in procs:
        if p.poll() is None:
            p.kill()
    codes = [p.wait() for p in procs]
    print(f"world {args.world}{' keep-graphs' if args.keep_graphs else ''}: "
          f"exit codes {codes} after {time.monotonic() - t:.1f} s")
    for r, log in enumerate(logs):
        text = open(log).read()
        print(f"--- rank {r}")
        print(text[-3500:])
    if any(codes):
        return 1
    verdict = _verdict(where, args.world)
    print("verdict", verdict)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
