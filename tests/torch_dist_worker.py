"""One rank of the port's multi-device paths over a gloo process group on
the CPU, for ``tests/test_torch_distributed.py``.

    python tests/torch_dist_worker.py <scenario> <host:port> <world> <rank> <dir>

forms the group through ``initialize_distributed`` (gloo on the CPU; for
a ``card_`` scenario NCCL, rank r on ``cuda:r``), runs ``scenario`` on
meshes of the group's ranks and saves what it computed to
``<dir>/<scenario>-rank<rank>.pt``. The inputs are built here, from seeds,
by the same functions the tests call for their one-process runs; the
batched scenario also reads the JAX package's state and RANSAC draws from
``<dir>/jax_batch.npz``. This file imports the port alone.

- ``core``: the collectives over a line of ranks, the LK quad and one leg
  with their slots split over the ranks, ``sharded_ba_solve``,
  ``ring_ba_solve`` and ``sharded_posegraph_solve``.
- ``batch``: ``run_sequences_batched`` on (2, 1) and (1, 2) meshes of
  ranks on both LK routes, and the (2, 1) and (1, 2) mesh steps from JAX's
  state fed JAX's draws.
- ``card_core``, ``card_batch``: the split LK launches and the solvers,
  and ``run_sequences_batched`` on both routes on CARD_MESHES, one rank per
  card (tests/test_torch_cuda.py).
- ``graph`` (gloo, the CPU): the mesh step, the chunked scan and the
  solvers (``graph_paths``) by default, where gloo ranks step eagerly by
  rule, with the graphs built counted, and in the CPU form of their graph
  paths (``body_form``), with the collectives each path's captures issued
  and the captures holding collectives before and after the group is
  destroyed; ``card_graph`` (NCCL, one rank per card, and at world size 1
  on one card): the same paths inside ``utils.cudagraph.dispatch(False)``
  and by default, replayed from CUDA graphs, every capture logged (tests/test_torch_graph_mesh.py, scripts/nccl_graph_probe.py).

Each rank destroys its process group before it saves its results (the
graph scenarios with the teardown's seconds and the captures still holding
collectives after it).
"""

import contextlib
import functools
import logging
import os
import socket
import subprocess
import sys
import time
import weakref

import numpy as np
import torch

torch.set_num_threads(1)

from visual_odom_tpu_torch.ba import posegraph, problem  # noqa: E402
from visual_odom_tpu_torch.config import (CameraIntrinsics,  # noqa: E402
                                          VOConfig)
from visual_odom_tpu_torch.interop import state_from_numpy  # noqa: E402
from visual_odom_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticStereoSequence)
from visual_odom_tpu_torch.ops import lk_cuda  # noqa: E402
from visual_odom_tpu_torch.ops.lk import (LKParams,  # noqa: E402
                                          lk_track_pyramid, prepare_lk_image)
from visual_odom_tpu_torch.parallel import (batch, collectives,  # noqa: E402
                                            ring_ba, sharded_ba)
from visual_odom_tpu_torch.parallel.batch_eval import (  # noqa: E402
    run_sequences_batched)
from visual_odom_tpu_torch.parallel.mesh import (  # noqa: E402
    initialize_distributed, make_mesh, mesh_axis, visible_devices)
from visual_odom_tpu_torch.parallel.ring_ba import ring_ba_solve  # noqa: E402
from visual_odom_tpu_torch.parallel.sharded_ba import (  # noqa: E402
    sharded_ba_solve)
from visual_odom_tpu_torch.runner import pipeline  # noqa: E402
from visual_odom_tpu_torch.utils import cudagraph  # noqa: E402

H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=W / 2, cy=H / 2, bf=-120.0 * 0.54,
            width=W, height=H)
#: sharded BA: 61 landmarks, split unevenly over 2 and 4 shards
BA = dict(num_poses=6, num_landmarks=61, seed=3, obs_window=2)
BA_ITERS = 4
#: the ring: tests/test_ring_ba.py's 16-pose problem (tracks of 2 poses)
RING = dict(num_poses=16, num_landmarks=128, pixel_noise=0.2,
            pose_perturb=0.015, landmark_perturb=0.08, seed=3, obs_window=1)
#: the pose graph: a drifted circle of 39 nodes and 39 edges (38 in
#: sequence, one loop), padded with a zero-weight edge to 40
GRAPH_NODES = 39
#: the batched runs: B sequences, steps, chunk and the draws' steps
BATCH_B = 3
BATCH_STEPS = 12
BATCH_CHUNK = 6
BATCH_CFG = dict(ransac_iterations=100, lk_max_iters=10)
JAX_STEPS = (4, 5, 6)
MESHES = ((2, 1), (1, 2))
ROUTES = ("pallas", "xla")
#: the meshes of one rank per card, by world size
CARD_MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
#: the graph scenarios: sequences, steps (the scan's chunk too) and the
#: meshes by world size; the solvers' iterations
GRAPH_B = 2
GRAPH_STEPS = 2
GRAPH_MESHES = {1: ((1, 1),), 2: ((2, 1), (1, 2)), 4: ((2, 2), (1, 4))}
GRAPH_ITERS = 3


def collective_inputs(D: int) -> dict:
    """Per-shard operands: values whose float sum depends on the order, a
    vector per shard and shards of unequal lengths."""
    rng = np.random.default_rng(D)
    order = [1e8, 1.0, -1e8, 1.0]
    return {
        "order": [torch.tensor([order[k % 4]], dtype=torch.float32)
                  for k in range(D)],
        "vec": [torch.from_numpy(rng.normal(size=5).astype(np.float32))
                for _ in range(D)],
        "ragged": [torch.from_numpy(rng.normal(size=(3 - k % 2, 2))
                                    .astype(np.float32)) for k in range(D)]}


def line_perm(D: int) -> list:
    """k -> k + 1: shard 0 receives nothing."""
    return [(k, k + 1) for k in range(D - 1)]


def ring_perm(D: int) -> list:
    return [(k, (k + 1) % D) for k in range(D)]


def run_collectives(inputs: dict, D: int, axis) -> dict:
    """Every collective on this process's shards of ``inputs``; the results
    of the shards it holds, by shard index."""
    mine = collectives.shards(axis)

    def local(name):
        return [inputs[name][k] for k, _ in mine]

    psum_order = collectives.psum(local("order"), axis)
    bcast = collectives.broadcast(inputs["vec"][0] if mine[0][0] == 0
                                  else torch.zeros(5), axis)
    out = {"psum_order": psum_order,
           "psum_vec": collectives.psum(local("vec"), axis),
           "broadcast": bcast,
           "ppermute_line": collectives.ppermute(local("vec"), line_perm(D),
                                                 axis),
           "ppermute_ring": collectives.ppermute(local("vec"), ring_perm(D),
                                                 axis),
           "replicated": collectives.replicated(
               axis, lambda a, b: a * 3.0 + b, psum_order, bcast),
           "gather": [torch.cat(collectives.gather(
               local("ragged"), axis,
               sizes=[x.shape[0] for x in inputs["ragged"]]))] * len(mine)}
    return {name: {k: v for (k, _), v in zip(mine, vals)}
            for name, vals in out.items()}


def quad_inputs(device="cpu"):
    """A batched quad of two sequences' frames 0 and 1 at 120x160, 48
    slots (some invalid), seeds within +-1.5 px, on ``device``."""
    intr = CameraIntrinsics(**INTR)
    frames = [list(SyntheticStereoSequence(intr, num_frames=2, seed=s,
                                           speed=0.5)) for s in range(2)]
    params = LKParams(max_iters=10)
    imgs = [prepare_lk_image(torch.from_numpy(np.stack(
        [f[t][s] for f in frames]).astype(np.float32)).to(device), params)
        for t, s in ((0, 0), (0, 1), (1, 1), (1, 0))]
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(np.stack([rng.uniform(15, W - 15, (2, 48)),
                                     rng.uniform(15, H - 15, (2, 48))],
                                    axis=-1).astype(np.float32))
    valid = torch.from_numpy(rng.random((2, 48)) < 0.85)
    flow = torch.from_numpy(rng.uniform(-1.5, 1.5, (2, 48, 2))
                            .astype(np.float32))
    return imgs, pts.to(device), valid.to(device), flow.to(device), params


def run_lk(slot_devices, start_level: int = 2, device="cpu") -> dict:
    """The quad and one leg L0 -> R0 on ``quad_inputs`` on ``device``,
    slots split over ``slot_devices`` (None: unsplit)."""
    imgs, pts, valid, flow, params = quad_inputs(device)
    quad = lk_cuda.lk_circular_quad(*imgs, pts, valid, params, flow=flow,
                                    disp=-flow, start_level=start_level,
                                    slot_devices=slot_devices)
    leg = lk_track_pyramid(imgs[0], imgs[1], pts, valid, params,
                           init_pts=pts - flow, start_level=start_level,
                           slot_devices=slot_devices)
    return {"quad": list(quad), "leg": list(leg)}


def ba_problem():
    return problem.synthetic_ba_problem(device="cpu", **BA)[0]


def ring_problems() -> dict:
    """The ring's problem, and the same with one gross outlier (Huber)."""
    p = problem.synthetic_ba_problem(device="cpu", **RING)[0]
    obs = p.observations.clone()
    w, lm = np.argwhere(p.mask.numpy())[0]
    obs[w, lm, :2] += 25.0
    return {"halo2": p, "huber": p._replace(observations=obs)}


#: the ring's two solves: ring_ba_solve keywords
RING_RUNS = {"halo2": dict(halo=2, rounds=10),
             "huber": dict(halo=None, rounds=8, huber_delta=1.5)}


def circle_graph():
    """A drifted circle of GRAPH_NODES keyframes closed by one loop edge."""
    n = GRAPH_NODES
    th = 2 * np.pi * np.arange(n) / n
    truth = np.tile(np.eye(4), (n, 1, 1))
    truth[:, 0, 0] = truth[:, 2, 2] = np.cos(th)
    truth[:, 0, 2], truth[:, 2, 0] = np.sin(th), -np.sin(th)
    truth[:, 0, 3], truth[:, 2, 3] = 10 * np.sin(th), 10 * (1 - np.cos(th))
    rng = np.random.default_rng(3)
    est = truth.copy()
    est[:, :3, 3] += np.cumsum(rng.normal(0, 0.02, (n, 3)), axis=0)
    return posegraph.build_keyframe_graph(
        est, np.arange(n), [(0, n - 1, np.linalg.inv(truth[0]) @ truth[-1],
                             10.0)], device="cpu")


def run_solvers(devices, D: int) -> dict:
    """The three solvers on meshes of ``devices``: landmark shards on a
    (1, D) mesh and on the model axis of a (2, D / 2) mesh (each data row
    solves alike), the ring on a "seq" axis of D, the graph's edges over a
    "model" axis of D."""
    out = {}
    p = ba_problem()
    meshes = {"1xD": {"data": 1, "model": D},
              "rows": {"data": 2, "model": D // 2}}
    for name, axes in meshes.items():
        got = sharded_ba_solve(p, make_mesh(axes, devices),
                               iterations=BA_ITERS)
        out[f"sharded_ba_{name}"] = [got.poses, got.landmarks]
    seq = make_mesh({"seq": D}, devices)
    for name, prob in ring_problems().items():
        got = ring_ba_solve(prob, seq, **RING_RUNS[name])
        out[f"ring_{name}"] = [got.poses, got.landmarks]
    got = posegraph.sharded_posegraph_solve(
        circle_graph(), make_mesh({"model": D}, devices), iterations=8)
    out["posegraph"] = [got.nodes]
    return out


def batch_sequences() -> list:
    """BATCH_B sequences of BATCH_STEPS + 1 frames at 120x160."""
    intr = CameraIntrinsics(**INTR)
    return [list(SyntheticStereoSequence(intr, num_frames=BATCH_STEPS + 1,
                                         seed=s, speed=0.5))
            for s in range(BATCH_B)]


def batch_config(route: str) -> VOConfig:
    return VOConfig.for_image(H, W, lk_backend=route, **BATCH_CFG)


def run_batch(devices, sequences, meshes=MESHES) -> dict:
    """``run_sequences_batched`` on each of ``meshes`` and ROUTES: the
    poses and the stats."""
    intr = CameraIntrinsics(**INTR)
    out = {}
    for shape in meshes:
        for route in ROUTES:
            mesh = make_mesh({"data": shape[0], "model": shape[1]}, devices)
            poses, stats, _ = run_sequences_batched(
                sequences, batch_config(route), intr, seed=1,
                chunk=BATCH_CHUNK, mesh=mesh)
            out[f"{shape[0]}x{shape[1]}_{route}"] = {
                "poses": [torch.from_numpy(p) for p in poses],
                "accept": torch.tensor([s["accept_ratio"] for s in stats],
                                       dtype=torch.float64),
                "inliers": torch.tensor([s["mean_inliers"] for s in stats],
                                        dtype=torch.float64)}
    return out


def jax_fed_steps(devices, path: str, wait_s: float = 90.0) -> dict:
    """The mesh step of each of MESHES from the JAX package's batched state
    after frame 3, fed JAX's draws for JAX_STEPS (``path``: the test's
    npz, waited for up to ``wait_s`` seconds: the test computes it while
    the ranks run): the outputs of each step."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > wait_s:
            raise TimeoutError(f"{path} did not appear in {wait_s} s")
        time.sleep(0.2)
    d = np.load(path)
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, ransac_iterations=BATCH_CFG[
        "ransac_iterations"])
    out = {}
    for shape in MESHES:
        mesh = make_mesh({"data": shape[0], "model": shape[1]}, devices)
        me = batch._rank_row(mesh)
        a, b = me.ranges(d["lefts0"].shape[0])[me.row]
        state = batch.MeshState((state_from_numpy(jax_rows(d, a, b), seed=a,
                                                  device=me.device),))
        step = batch.make_batched_step_fn(cfg, intr, mesh=mesh)
        outs = []
        for s in JAX_STEPS:
            state, o = step(state, torch.from_numpy(d[f"lefts{s}"]),
                            torch.from_numpy(d[f"rights{s}"]),
                            uniforms=torch.from_numpy(d[f"uniforms{s}"]))
            outs.append({k: getattr(o, k) for k in o._fields})
        out[f"{shape[0]}x{shape[1]}"] = outs
    return out


def jax_rows(d, a: int, b: int) -> dict:
    """Sequences a..b of the JAX state saved as ``state_*`` arrays, in the
    form ``interop.state_from_numpy`` takes."""
    def image(prefix):
        n = int(d[f"{prefix}_levels"])
        return {"pyramid": [d[f"{prefix}_pyramid{i}"][a:b] for i in range(n)],
                "shapes": [tuple(s) for s in d[f"{prefix}_shapes"]],
                "pad": int(d[f"{prefix}_pad"])}

    feats = ("points", "ages", "valid", "ids", "next_id", "flow", "disp")
    return {"features": {k: d[f"state_features_{k}"][a:b] for k in feats},
            "lk_l0": image("state_lk_l0"), "lk_r0": image("state_lk_r0"),
            "tvec": d["state_tvec"][a:b]}


# ---- the graph paths ------------------------------------------------------------


@contextlib.contextmanager
def body_form():
    """Route the batched step's rows and the three solvers to their graph
    paths in the CPU form: ``use_graph_on`` says yes wherever a graph is not
    switched off (on the CPU and on gloo ranks too), and each factory
    builds its ``GraphedStep`` or ``GraphedLoop`` with
    ``_replay_body=True`` (the static buffers and loops a capture records,
    each replay the body itself), once per key. Yields the objects each
    factory made, by factory."""
    def use(axis, graphed=None):
        graphed = cudagraph._DISPATCH if graphed is None else graphed
        return graphed is not False

    made = {}

    def recorded(name, factory):
        made[name] = []

        @functools.lru_cache(maxsize=None)
        def build(*args, **kwargs):
            made[name].append(factory(*args, **kwargs, _replay_body=True))
            return made[name][-1]

        return build

    def one_device(config, intrinsics, with_tracks, device, _replay_body):
        return cudagraph.GraphedStep(pipeline.make_step_fn(
            config, intrinsics, with_tracks=with_tracks, device=device),
            device, _replay_body=_replay_body)

    patches = [(batch, "_graphed_step", recorded("one_device", one_device))]
    for name, (m, attr) in {"split": (batch, "_graphed_split_step"),
                            "sharded_ba": (sharded_ba, "_graphed_solve"),
                            "ring": (ring_ba, "_graphed_round"),
                            "posegraph": (posegraph,
                                          "_graphed_sharded_solve")}.items():
        patches.append((m, attr, recorded(name, getattr(m, attr).__wrapped__)))
    patches += [(m, "use_graph_on", use)
                for m in (batch, sharded_ba, ring_ba, collectives)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    try:
        for m, name, value in patches:
            setattr(m, name, value)
        yield made
    finally:
        for m, name, value in saved:
            setattr(m, name, value)


def _count_replays():
    """The replays each capture made, by capture: the captures keep no
    count, so the ``replay`` of each of ``utils.cudagraph``'s capture forms
    is wrapped to count them, once in a process."""
    if hasattr(cudagraph._Capture.replay, "counts"):
        return cudagraph._Capture.replay.counts
    counts = weakref.WeakKeyDictionary()
    for cls in (cudagraph._Capture, cudagraph._BodyCapture):
        def counted(self, _replay=cls.__dict__["replay"]):
            counts[self] = counts.get(self, 0) + 1
            return _replay(self)
        counted.counts = counts
        cls.replay = counted
    return counts


#: the replays each capture made (``_count_replays``)
REPLAYS = _count_replays()


def replays(graphs) -> list:
    """The replays each of ``graphs`` (``GraphedStep``s or
    ``GraphedLoop``s) made, over all its captures."""
    return [sum(REPLAYS.get(c, 0) for c in g.captures.values())
            for g in graphs]


@contextlib.contextmanager
def graphs_built():
    """Count the ``GraphedStep``s and ``GraphedLoop``s made in the block:
    yields a list that gets one entry per graph object made."""
    made = []
    inits = {cls: cls.__init__ for cls in (cudagraph.GraphedStep,
                                           cudagraph.GraphedLoop)}

    def counted(init):
        def wrapper(self, *args, **kwargs):
            made.append(type(self).__name__)
            init(self, *args, **kwargs)
        return wrapper

    try:
        for cls, init in inits.items():
            cls.__init__ = counted(init)
        yield made
    finally:
        for cls, init in inits.items():
            cls.__init__ = init


def graph_sequences() -> list:
    """GRAPH_B sequences of GRAPH_STEPS + 1 frames at 120x160."""
    intr = CameraIntrinsics(**INTR)
    return [list(SyntheticStereoSequence(intr, num_frames=GRAPH_STEPS + 1,
                                         seed=s, speed=0.5))
            for s in range(GRAPH_B)]


def _stacked(sequences, i):
    return tuple(np.stack([s[i][k] for s in sequences]) for k in (0, 1))


def _own(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` on the CPU (a graph's outputs and states are views
    of its byte buffers; ``torch.save`` keeps each tensor whole)."""
    return t.to("cpu", copy=True)


def _state_summary(state) -> dict:
    """A batched state's tensors (on the CPU) and its generators' states,
    row by row."""
    rows = state.rows if isinstance(state, batch.MeshState) else (state,)
    return {"tensors": [_own(t) for r in rows
                        for t in cudagraph.state_tensors(r)],
            "generators": [g.get_state() for r in rows
                           for g in cudagraph.generators(r)]}


def _counted(fn, issued=None, name=None) -> dict:
    """``fn()``'s result with the LK launches it counted; with ``issued``
    (a dict) also ``issued[name]``, the collectives of the captures ``fn``
    replayed (``captured_collectives``)."""
    before = cudagraph.launch_counts()
    seen = _replays_by_capture()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    after = cudagraph.launch_counts()
    if issued is not None:
        issued[name] = captured_collectives(seen)
    return {"out": out, "launches": {k: after[k] - before[k] for k in after}}


def _captures():
    return [c for g in list(cudagraph._GRAPHED) for c in g.captures.values()]


def _replays_by_capture() -> dict:
    return {id(c): REPLAYS.get(c, 0) for c in _captures()}


def captured_collectives(seen: dict) -> list:
    """The collectives (kind, group ranks, shape, dtype, ppermute pairs) of
    every capture replayed since ``seen`` (``_replays_by_capture``), in
    capture order, captures ordered by label and then by their lists."""
    caps = [c for c in _captures()
            if REPLAYS.get(c, 0) > seen.get(id(c), 0)]
    lists = sorted((c.label, [(x.kind, x.ranks, x.shape, str(x.dtype),
                               x.pairs) for x in c.collectives])
                   for c in caps)
    return [x for _, issued in lists for x in issued]


def held_captures() -> int:
    """The captures alive that hold collectives of a process group."""
    return sum(bool(c.collectives) for c in _captures())


def mesh_step_run(config, sequences, mesh, steps=GRAPH_STEPS,
                  device=None) -> dict:
    """``steps`` batched steps on ``mesh`` from frames on ``device`` (the
    host by default): every step's outputs and the final state."""
    intr = CameraIntrinsics(**INTR)
    step = batch.make_batched_step_fn(config, intr, mesh=mesh)
    st = batch.batched_init_state(config, *_stacked(sequences, 0), seed=1,
                                  mesh=mesh)
    outs = []
    for i in range(1, steps + 1):
        st, out = step(st, *(torch.from_numpy(x).to(device or "cpu")
                             for x in _stacked(sequences, i)))
        outs.append([_own(x) for x in out])
    return {"outputs": outs, **_state_summary(st)}


def mesh_scan_run(config, sequences, mesh, steps=GRAPH_STEPS) -> dict:
    """One chunk of ``steps`` frames through the mesh's scan: the stacked
    outputs and the final state."""
    intr = CameraIntrinsics(**INTR)
    scan = batch.make_batched_scan_fn(config, intr, steps, mesh=mesh)
    st = batch.batched_init_state(config, *_stacked(sequences, 0), seed=1,
                                  mesh=mesh)
    frames = [_stacked(sequences, i) for i in range(1, steps + 1)]
    st, out = scan(st, *(np.stack(x) for x in zip(*frames)))
    return {"outputs": [_own(x) for x in out], **_state_summary(st)}


def graph_solvers(devices, D: int, device="cpu", issued=None) -> dict:
    """The three solvers over a line of D ``devices``: landmark shards on a
    (1, D) mesh, the ring (halo 2; auto halo with Huber) on a "seq" axis,
    the graph's edges over a "model" axis; problems on ``device``.
    ``issued`` as ``_counted``'s, by path name."""
    out = {}
    p = problem.synthetic_ba_problem(device=device, **BA)[0]
    got = _counted(lambda: sharded_ba_solve(
        p, make_mesh({"data": 1, "model": D}, devices),
        iterations=GRAPH_ITERS), issued, "sharded_ba")
    out["sharded_ba"] = dict(got, out=[_own(x) for x in got["out"][:2]])
    seq = make_mesh({"seq": D}, devices)
    for name, prob in ring_problems().items():
        prob = prob._replace(**{k: getattr(prob, k).to(device) for k in (
            "poses", "landmarks", "observations", "mask")})
        kw = dict(RING_RUNS[name], rounds=GRAPH_ITERS)
        got = _counted(lambda: ring_ba_solve(prob, seq, **kw), issued,
                       f"ring_{name}")
        out[f"ring_{name}"] = dict(got, out=[_own(x) for x in got["out"][:2]])
    g = circle_graph()
    g = g._replace(**{k: getattr(g, k).to(device) for k in g._fields})
    got = _counted(lambda: posegraph.sharded_posegraph_solve(
        g, make_mesh({"model": D}, devices), iterations=GRAPH_ITERS),
        issued, "posegraph")
    out["posegraph"] = dict(got, out=[_own(got["out"].nodes)])
    return out


def graph_paths(devices, world: int, device="cpu", routes=("pallas",),
                issued=None) -> dict:
    """The mesh step and the chunked scan on GRAPH_MESHES[world] (and each
    LK route of ``routes``) and the solvers, each with the launches it
    counted, by path name; ``issued`` as ``_counted``'s."""
    sequences = graph_sequences()
    out = {}
    for shape in GRAPH_MESHES[world]:
        for route in routes:
            cfg = batch_config(route)
            mesh = make_mesh({"data": shape[0], "model": shape[1]}, devices)
            name = f"{shape[0]}x{shape[1]}_{route}"
            out[f"step_{name}"] = _counted(lambda: mesh_step_run(
                cfg, sequences, mesh, device=device), issued, f"step_{name}")
            out[f"scan_{name}"] = _counted(lambda: mesh_scan_run(
                cfg, sequences, mesh), issued, f"scan_{name}")
    out.update(graph_solvers(devices, world, device, issued))
    return out


# ---- the launcher: spawns a set of ranks and waits for them ------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a set of ranks may take, each rank (CARD_GRAPH_TIMEOUT for the
#: ``card_graph`` scenario: both LK routes graphed and eager on each mesh)
TIMEOUT = 120
CARD_GRAPH_TIMEOUT = 300


def start_ranks(scenario, world, where):
    """Spawn the ranks of one set on a free port; each writes its log to
    ``where``. CPU scenarios hide the cards."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    if not scenario.startswith("card_"):
        env["CUDA_VISIBLE_DEVICES"] = ""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    procs = []
    for r in range(world):
        log = open(os.path.join(where, f"{scenario}-rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), scenario,
             coordinator, str(world), str(r), str(where)], env=env,
            stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def finish_ranks(procs, scenario, where, timeout=TIMEOUT):
    """Wait for every rank (``timeout`` seconds from now), killing them all
    on a failure or a timeout. Returns (all exited 0, the ranks' logs)."""
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    logs = [open(os.path.join(where, f"{scenario}-rank{r}.log")).read()
            for r in range(len(procs))]
    return all(p.returncode == 0 for p, _ in procs), logs


def run_ranks(scenario, world, where, during=None, timeout=TIMEOUT):
    """One set of ranks to its end (``during()`` runs in the caller
    meanwhile); returns (each rank's saved results, on the CPU,
    ``during()``'s result). Retries once on a port taken between choosing
    and binding it; raises with the ranks' logs on any other failure."""
    for attempt in (0, 1):
        procs = start_ranks(scenario, world, where)
        extra = None
        try:
            extra = during() if during is not None else None
        finally:
            ok, logs = finish_ranks(procs, scenario, where, timeout)
        if ok:
            return [torch.load(os.path.join(where, f"{scenario}-rank{r}.pt"),
                               map_location="cpu", weights_only=False)
                    for r in range(world)], extra
        if attempt == 0 and any("ddress already in use" in t for t in logs):
            continue
        raise AssertionError(f"{scenario} over {world} ranks failed:\n"
                             + "\n".join(t[-3000:] for t in logs))


def main() -> int:
    scenario, coordinator, world, rank, where = sys.argv[1:6]
    world, rank = int(world), int(rank)
    card = scenario.startswith("card_")
    initialize_distributed(coordinator=coordinator, num_processes=world,
                           process_id=rank,
                           device=torch.device("cuda", rank) if card
                           else "cpu")
    devices = visible_devices()
    assert [p.rank for p in devices] == list(range(world))
    if card:
        assert [p.device for p in devices] == [
            torch.device("cuda", r) for r in range(world)]
    if scenario == "card_core":
        axis = mesh_axis(make_mesh({"x": world}, devices), "x")
        res = {"lk": run_lk(axis, device=devices[rank].device),
               **run_solvers(devices, world)}
    elif scenario == "card_batch":
        res = {"runs": run_batch(devices, batch_sequences(),
                                 CARD_MESHES[world])}
    elif scenario == "core":
        axis = mesh_axis(make_mesh({"x": world}, devices), "x")
        res = {"collectives": run_collectives(collective_inputs(world), world,
                                              axis),
               "lk": run_lk(axis), **run_solvers(devices, world)}
    elif scenario == "graph":
        with graphs_built() as built:
            default = graph_paths(devices, world)
        issued = {}
        # ``made`` keeps the body form's graph objects, and so their
        # captures, alive up to the teardown
        with body_form() as made:
            body = graph_paths(devices, world, issued=issued)
        res = {"default": default, "graphs_built": list(built),
               "body": body, "issued": issued,
               "held_before_teardown": held_captures()}
    elif scenario == "card_graph":
        # each capture's warm-up, capture and end in the rank's log, so
        # that a hang names the body whose collectives it waits in
        log = logging.getLogger(cudagraph.__name__)
        log.addHandler(logging.StreamHandler())
        log.handlers[-1].setFormatter(logging.Formatter(
            f"%(asctime)s rank {rank}: %(message)s"))
        log.setLevel(logging.DEBUG)
        dev = devices[rank].device
        with cudagraph.dispatch(False):
            eager = graph_paths(devices, world, dev, ROUTES)
        issued = {}
        with graphs_built() as built:
            graphed = graph_paths(devices, world, dev, ROUTES, issued)
        line = mesh_axis(make_mesh({"x": world}, devices), "x")
        with cudagraph.dispatch(True):
            accepts = collectives.use_graph_on(line)
        res = {"eager": eager, "graphed": graphed, "issued": issued,
               "graphs_built": list(built), "line_accepts_graph": accepts,
               "held_before_teardown": held_captures()}
    elif scenario == "batch":
        res = {"runs": run_batch(devices, batch_sequences()),
               "jax_fed": jax_fed_steps(devices, os.path.join(
                   where, "jax_batch.npz"))}
    else:
        raise ValueError(f"unknown scenario {scenario!r}")
    t = time.monotonic()
    torch.distributed.destroy_process_group()
    if scenario in ("graph", "card_graph"):
        res.update(teardown_s=time.monotonic() - t,
                   held_after_teardown=held_captures(),
                   teardown_releases=getattr(
                       torch.distributed.destroy_process_group,
                       "releases_graphs", False))
    torch.save(res, os.path.join(where, f"{scenario}-rank{rank}.pt"))
    print(f"rank {rank} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
