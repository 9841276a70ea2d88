"""The port's multi-device paths across processes, one rank per position,
over gloo on the CPU (``tests/torch_dist_worker.py`` is each rank; the
workers import the port alone, and the JAX references are computed here).

- With 2 and 4 ranks: ``psum`` (a sum whose float result depends on the
  order), ``broadcast``, ``ppermute`` (a shard that receives nothing, and a
  ring), ``replicated`` and ``gather`` (shards of unequal lengths) equal the
  one-process collectives over ``["cpu"] * D`` bit for bit, on every rank.
- The LK quad and one leg with their slots split over the ranks equal the
  unsplit calls bit for bit (ROADMAP item 18d, rank form).
- ``sharded_ba_solve`` (61 landmarks: an uneven split; with 4 ranks also
  the model axis of a (2, 2) mesh), ``ring_ba_solve`` (halo 2; auto halo
  with Huber) and ``sharded_posegraph_solve`` (39 edges, padded) equal
  their one-process runs on the same mesh shape bit for bit, on every
  rank. The ring of 4 ranks is also held to the JAX package's
  ``ring_ba_solve`` on the conftest's CPU devices within
  tests/test_torch_ring_ba.py's bounds.
- The slice as a whole: ``run_sequences_batched`` on (2, 1) and (1, 2)
  meshes of 2 ranks, both LK routes, equals the one-process mesh run bit
  for bit on both ranks. The mesh step from the JAX package's batched
  state, fed JAX's draws, is held to JAX's sharded batched step on a
  (2, 1) CPU mesh as tests/test_torch_batch_mesh.py holds the one-process
  step: equal counts, T^-1 within ROT_TOL and TRANS_TOL, except that a
  step whose inlier count differs by one (a PnP inlier flipped at the
  reprojection threshold, the knife edge of ROADMAP queue 3) is held only
  to its counts.
- A rank named twice is refused, as are batched checkpoints on a mesh of
  ranks, and a group whose peer never comes fails its test within the
  spawn timeout instead of hanging the suite.

Every spawned rank has a timeout of at most 120 s and is killed in a
``finally``; each worker set takes a fresh port and retries once on
"address in use". About 100 s alone.
"""

import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_dist_worker as wk
from test_torch_batch import ROT_TOL, TRANS_TOL, _numpy_state
from visual_odom_tpu.ba import problem as jproblem
from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
from visual_odom_tpu.config import VOConfig as JVOConfig
from visual_odom_tpu.parallel import ring_ba as jring
from visual_odom_tpu.parallel.batch import batched_init_state as jax_init
from visual_odom_tpu.parallel.batch import make_batched_step_fn as jax_step
from visual_odom_tpu.parallel.mesh import make_mesh as jax_mesh
from visual_odom_tpu_torch.config import CameraIntrinsics
from visual_odom_tpu_torch.parallel.batch_eval import run_sequences_batched
from visual_odom_tpu_torch.parallel.mesh import Rank, make_mesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: ring against JAX's ring: tests/test_torch_ring_ba.py's bounds
RING_TOL = 1e-4
HUBER_TOL = 5e-4
COLLECTIVES = ("psum_order", "psum_vec", "broadcast", "ppermute_line",
               "ppermute_ring", "replicated", "gather")


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


# ---- the core scenario: collectives, the split LK launches, the solvers -------


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def core(request, tmp_path_factory):
    """Each rank's results over ``world`` ranks, and the one-process runs
    over ``["cpu"] * world``."""
    world = request.param
    where = str(tmp_path_factory.mktemp(f"core{world}"))

    def one_process():
        devs = [CPU] * world
        return {"collectives": wk.run_collectives(wk.collective_inputs(world),
                                                  world, devs),
                "lk_unsplit": wk.run_lk(None), "lk": wk.run_lk(devs),
                **wk.run_solvers(devs, world)}

    ranks, ref = wk.run_ranks("core", world, where, during=one_process)
    return world, ranks, ref


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collectives_equal_one_process(core, name):
    """Rank k's shard equals shard k of the one-process collective."""
    world, ranks, ref = core
    for k, res in enumerate(ranks):
        assert list(res["collectives"][name]) == [k]
        assert _equal(res["collectives"][name][k],
                      ref["collectives"][name][k]), (name, k)


def test_psum_adds_in_shard_order(core):
    """((x0 + x1) + x2) + x3 with x = 1e8, 1, -1e8, 1 in float32, on
    every rank: 1.0 with 4 ranks, where an all-reduce adding in another
    order may give 0.0 or 2.0."""
    world, ranks, _ = core
    xs = wk.collective_inputs(world)["order"]
    want = xs[0]
    for x in xs[1:]:
        want = want + x
    for k, res in enumerate(ranks):
        assert torch.equal(res["collectives"]["psum_order"][k], want)
    assert float(want) == (1.0 if world == 4 else 1e8)


def test_ppermute_zero_fills_the_shard_that_receives_nothing(core):
    _, ranks, _ = core
    assert torch.equal(ranks[0]["collectives"]["ppermute_line"][0],
                       torch.zeros(5))
    vec = wk.collective_inputs(len(ranks))["vec"]
    for k in range(1, len(ranks)):
        assert torch.equal(ranks[k]["collectives"]["ppermute_line"][k],
                           vec[k - 1])


@pytest.mark.parametrize("what", ["quad", "leg"])
def test_split_lk_over_ranks_equals_unsplit(core, what):
    """18d, rank form: each rank launches its slice of the slots and the
    slices are gathered; every rank holds the unsplit call's bits, as does
    the one-process split over ``["cpu"] * world``."""
    _, ranks, ref = core
    assert ref["lk_unsplit"][what][-1].sum() > 10
    assert _equal(ref["lk"][what], ref["lk_unsplit"][what])
    for res in ranks:
        assert _equal(res["lk"][what], ref["lk_unsplit"][what])


@pytest.mark.parametrize("solve", ["sharded_ba_1xD", "sharded_ba_rows",
                                   "ring_halo2", "ring_huber", "posegraph"])
def test_solvers_over_ranks_equal_one_process(core, solve):
    """Every rank returns the whole solved problem or graph, the same bits
    as the one-process solve on the same mesh shape."""
    _, ranks, ref = core
    for res in ranks:
        assert _equal(res[solve], ref[solve]), solve


@pytest.mark.parametrize("name", ["halo2", "huber"])
def test_ring_over_ranks_within_jax_ring(core, name):
    """The ring over ranks against the JAX package's ``ring_ba_solve`` on
    the same number of CPU devices."""
    world, ranks, _ = core
    p = wk.ring_problems()[name]
    jp = jproblem.BAProblem(**{k: (jnp.asarray(v.numpy())
                                   if isinstance(v, torch.Tensor) else v)
                               for k, v in p._asdict().items()})
    jout = jring.ring_ba_solve(jp, jax_mesh({"seq": world},
                                            devices=jax.devices()[:world]),
                               **wk.RING_RUNS[name])
    tol = HUBER_TOL if name == "huber" else RING_TOL
    got = ranks[0][f"ring_{name}"][0].numpy()
    assert np.abs(got - np.asarray(jout.poses)).max() < tol


# ---- the batched scenario: the slice as a whole --------------------------------


def _jax_reference(where):
    """JAX's sharded batched step on a (2, 1) CPU mesh: its state after
    frame 3 of BATCH_B sequences and, for each of JAX_STEPS, its draws,
    frames and outputs; the state, draws and frames go to the workers in
    ``jax_batch.npz``."""
    frames = [s[:max(wk.JAX_STEPS) + 1] for s in wk.batch_sequences()]

    def stack(i):
        return (np.stack([f[i][0] for f in frames]),
                np.stack([f[i][1] for f in frames]))

    jcfg = JVOConfig.for_image(wk.H, wk.W, ransac_iterations=wk.BATCH_CFG[
        "ransac_iterations"])
    m = jax_mesh({"data": 2, "model": 1})
    jstep = jax_step(jcfg, JIntrinsics(**wk.INTR), m)
    jst = jax_init(jcfg, *stack(0), m, seed=0)
    for i in range(1, min(wk.JAX_STEPS)):
        jst, _ = jstep(jst, *(jnp.asarray(x) for x in stack(i)))
    d = _numpy_state(jst)
    arrays = {"lefts0": stack(0)[0], "rights0": stack(0)[1],
              "state_tvec": d["tvec"]}
    for k, v in d["features"].items():
        arrays[f"state_features_{k}"] = v
    for im in ("lk_l0", "lk_r0"):
        arrays[f"state_{im}_levels"] = np.asarray(len(d[im]["pyramid"]))
        arrays[f"state_{im}_shapes"] = np.asarray(d[im]["shapes"])
        arrays[f"state_{im}_pad"] = np.asarray(d[im]["pad"])
        for i, p in enumerate(d[im]["pyramid"]):
            arrays[f"state_{im}_pyramid{i}"] = p
    refs = []
    for s in wk.JAX_STEPS:
        arrays[f"uniforms{s}"] = np.stack([np.asarray(jax.random.uniform(
            jax.random.split(k)[1], (jcfg.ransac_iterations,
                                     jcfg.padded_features)))
            for k in jst.key])
        arrays[f"lefts{s}"], arrays[f"rights{s}"] = stack(s)
        jst, out = jstep(jst, *(jnp.asarray(x) for x in stack(s)))
        refs.append({k: np.asarray(v) for k, v in out._asdict().items()})
    path = os.path.join(where, "jax_batch.npz")
    np.savez(path + ".tmp.npz", **arrays)
    os.replace(path + ".tmp.npz", path)       # the ranks wait for it
    return refs


@pytest.fixture(scope="module")
def batch_runs(tmp_path_factory):
    """The two ranks' batched results; the one-process mesh runs and JAX's
    outputs, computed while the ranks work (they read JAX's state once it
    is written)."""
    where = str(tmp_path_factory.mktemp("batch"))
    seqs = wk.batch_sequences()

    def one_process():
        out = {"jax": _jax_reference(where)}
        for shape in wk.MESHES:
            mesh = make_mesh({"data": shape[0], "model": shape[1]},
                             devices=[CPU] * 2)
            for route in wk.ROUTES:
                poses, stats, _ = run_sequences_batched(
                    seqs, wk.batch_config(route), CameraIntrinsics(**wk.INTR),
                    seed=1, chunk=wk.BATCH_CHUNK, mesh=mesh)
                out[f"{shape[0]}x{shape[1]}_{route}"] = (poses, stats)
        return out

    ranks, ref = wk.run_ranks("batch", 2, where, during=one_process)
    return ranks, ref, ref.pop("jax")


@pytest.mark.parametrize("route", wk.ROUTES)
@pytest.mark.parametrize("shape", wk.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_batched_run_over_ranks_equals_one_process(batch_runs, shape,
                                                   route):
    """Every sequence's poses and stats on both ranks, bit for bit the
    one-process mesh run."""
    ranks, ref, _ = batch_runs
    key = f"{shape[0]}x{shape[1]}_{route}"
    poses, stats = ref[key]
    for res in ranks:
        got = res["runs"][key]
        assert len(got["poses"]) == wk.BATCH_B
        for a, b in zip(got["poses"], poses):
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(
            got["accept"].numpy(), [s["accept_ratio"] for s in stats])
        np.testing.assert_array_equal(
            got["inliers"].numpy(), [s["mean_inliers"] for s in stats])
    assert min(s["accept_ratio"] for s in stats) >= 0.9


@pytest.mark.parametrize("shape", wk.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_step_over_ranks_matches_jax(batch_runs, shape):
    """From JAX's batched state after frame 3, fed each sequence's JAX
    draws: the counts of every step equal JAX's, and T^-1 is within the
    step bounds except on a knife-edge step (inliers one apart)."""
    ranks, _, jax_refs = batch_runs
    key = f"{shape[0]}x{shape[1]}"
    for res in ranks:
        for out, ref in zip(res["jax_fed"][key], jax_refs):
            for name in ("num_bucketed", "num_matched", "accept"):
                np.testing.assert_array_equal(out[name].numpy(), ref[name],
                                              name)
            d_inl = np.abs(out["num_inliers"].numpy() - ref["num_inliers"])
            assert d_inl.max() <= 1
            dT = np.abs(out["T_inv"].numpy() - ref["T_inv"])
            held = d_inl == 0
            assert held.sum() >= len(held) - 1
            assert dT[held][:, :3, :3].max() < ROT_TOL
            assert dT[held][:, :3, 3].max() < TRANS_TOL
    assert _equal(ranks[0]["jax_fed"][key], ranks[1]["jax_fed"][key])


# ---- refusals and timeouts -------------------------------------------------------


def test_a_rank_named_twice_is_refused():
    with pytest.raises(ValueError, match="rank 0 would hold 2 mesh "
                                         "positions"):
        make_mesh({"x": 2}, devices=[Rank(0, CPU), Rank(0, CPU)])
    with pytest.raises(ValueError, match="devices or ranks, not both"):
        make_mesh({"x": 2}, devices=[Rank(0, CPU), CPU])
    mesh = make_mesh({"data": 1, "model": 2},
                     devices=[Rank(1, CPU), Rank(0, CPU)])
    assert mesh.ranks.tolist() == [[1, 0]] and mesh.shape == {"data": 1,
                                                             "model": 2}


def test_batched_checkpoints_refuse_a_mesh_of_ranks(tmp_path):
    """A snapshot would need every row's state at one writer: the
    restartable runner refuses a mesh of ranks before it starts."""
    mesh = make_mesh({"data": 2, "model": 1},
                     devices=[Rank(0, CPU), Rank(1, CPU)])
    with pytest.raises(ValueError, match="not written on a mesh of ranks"):
        run_sequences_batched(wk.batch_sequences()[:2], wk.batch_config(
            "pallas"), CameraIntrinsics(**wk.INTR), chunk=4, mesh=mesh,
            checkpoint_path=str(tmp_path / "ck.npz"))


def test_a_missing_peer_fails_within_the_timeout(tmp_path):
    """One rank of two never comes: the set fails, its rank killed, in
    seconds rather than at the group's own 30-minute timeout."""
    procs = wk.start_ranks("core", 2, str(tmp_path))
    procs[1][0].kill()
    t = time.monotonic()
    ok, _ = wk.finish_ranks(procs, "core", str(tmp_path), timeout=5)
    assert not ok and time.monotonic() - t < 15
    assert all(p.poll() is not None for p, _ in procs)
