"""The port's mono-rotation path against the JAX package:
``backend.five_point`` (Durand-Kerner roots, the five-point solver),
``backend.essential`` (Jacobi eigen-decomposition, 8-point polish,
closed-form decomposition, RANSAC with both solvers) and the step made with
``mono_rotation=True``, single, batched and through ``run_sequence_scan``.

The five-point solver's null-space basis is another orthonormal basis than
LAPACK's SVD gives, and the float32 elimination is chaotic at VO-like low
parallax (JAX's own float32 and float64 runs agree within 1e-3 on 12-14 of
64 minimal samples), so candidates are compared through what they solve:
the same null space, true essential matrices, and the ground truth
recovered as often as JAX recovers it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odom_tpu.backend import essential as jess
from visual_odom_tpu.backend import five_point as jfive
from visual_odom_tpu.config import CameraIntrinsics as JIntrinsics
from visual_odom_tpu.config import VOConfig as JVOConfig
from visual_odom_tpu.eval.kitti_eval import ate_rmse
from visual_odom_tpu.runner.pipeline import init_vo_state as jax_init
from visual_odom_tpu.runner.pipeline import make_step_fn as jax_make_step
from visual_odom_tpu_torch.backend import essential, five_point
from visual_odom_tpu_torch.config import CameraIntrinsics, VOConfig
from visual_odom_tpu_torch.core.lie import rodrigues
from visual_odom_tpu_torch.interop import state_from_numpy
from visual_odom_tpu_torch.io.synthetic import SyntheticStereoSequence
from visual_odom_tpu_torch.parallel import batch
from visual_odom_tpu_torch.runner import pipeline

torch.set_num_threads(1)

FX = 718.856
PP = (607.19, 185.21)
N_SAMPLES = 64
#: step parity bounds of tests/test_torch_pipeline.py
COUNT_FRAC, ROT_TOL, TRANS_TOL = 0.03, 2e-3, 2e-2
#: _eight_point: the port against JAX and against its own float64 run.
#: JAX's float32 eigh lies up to 1.07e-3 from the float64 answer on these
#: inputs, the port's Jacobi sweeps up to 1.3e-4 (measured)
EIGHT_POINT_TOL = 2e-3
EIGHT_POINT_F64_TOL = 5e-4


def make_two_view(n, seed, noise=0.0, outlier_frac=0.0,
                  rvec=None, t=None):
    """tests/test_essential.py's two-view scene: points 8-60 m ahead, a
    small rotation, mostly forward motion; pixels at the KITTI camera."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-12, 12, n), rng.uniform(-4, 4, n),
                  rng.uniform(8, 60, n)], axis=1)
    rvec = rng.normal(0, 0.02, 3) if rvec is None else np.asarray(rvec)
    R = rodrigues(torch.tensor(rvec)).numpy()
    t = (np.array([0.1, -0.02, 1.0]) + rng.normal(0, 0.1, 3)
         if t is None else np.asarray(t, np.float64))
    t = t / np.linalg.norm(t)
    X2 = X @ R.T + t
    uv1 = np.stack([X[:, 0] / X[:, 2] * FX + PP[0],
                    X[:, 1] / X[:, 2] * FX + PP[1]], 1)
    uv2 = np.stack([X2[:, 0] / X2[:, 2] * FX + PP[0],
                    X2[:, 1] / X2[:, 2] * FX + PP[1]], 1)
    uv1 += rng.normal(0, noise, uv1.shape)
    uv2 += rng.normal(0, noise, uv2.shape)
    out = rng.choice(n, int(outlier_frac * n), replace=False)
    uv2[out] += rng.uniform(10, 80, (len(out), 2))
    return uv1.astype(np.float32), uv2.astype(np.float32), R, t


def _normalized(uv):
    return ((uv - np.float32(PP)) / np.float32(FX)).astype(np.float32)


def _angle(Ra, Rb):
    return float(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1) / 2, -1, 1)))


# --- Durand-Kerner -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["gaussian", "real_roots"])
def test_durand_kerner_roots_as_sets(kind):
    """Seeded degree-10 polynomials: every root of one package lies within
    1e-3 (relative to 1 + |z|) of a root of the other."""
    rng = np.random.default_rng(1)
    if kind == "gaussian":
        coeffs = rng.normal(size=(24, 11)).astype(np.float32)
    else:
        # ten real roots 0.6 apart, jittered (clustered real roots are
        # float32-conditioned in both packages)
        coeffs = np.stack([np.polynomial.polynomial.polyfromroots(
            np.linspace(-2.7, 2.7, 10) + rng.uniform(-0.1, 0.1, 10))
            for _ in range(24)]).astype(np.float32)
    got = five_point._durand_kerner(torch.from_numpy(coeffs))
    assert got.dtype == torch.complex64
    got = got.numpy()
    for c, g in zip(coeffs, got):
        ref = np.asarray(jfive._durand_kerner(jnp.asarray(c)))
        for a, b in ((g, ref), (ref, g)):
            d = np.abs(a[:, None] - b[None, :]).min(axis=1) / (1 + np.abs(a))
            assert d.max() < 1e-3, d.max()


def test_polyval_and_conv_match_jax():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=4).astype(np.float32), rng.normal(size=5).astype(
        np.float32)
    z = rng.normal(size=7).astype(np.float32)
    np.testing.assert_allclose(
        five_point._conv(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jfive._conv(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        five_point._polyval(torch.from_numpy(b), torch.from_numpy(z)).numpy(),
        np.asarray(jfive._polyval(jnp.asarray(b), jnp.asarray(z))), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_array_equal(five_point._A64,
                                  jfive._triple_assignment())


# --- five-point solver -------------------------------------------------------


@pytest.fixture(scope="module")
def minimal_samples():
    """64 noise-free VO-like minimal samples, normalized, with their true
    E, and both packages' candidates."""
    xs = [make_two_view(5, s) for s in range(N_SAMPLES)]
    x1 = np.stack([_normalized(a) for a, _, _, _ in xs])
    x2 = np.stack([_normalized(b) for _, b, _, _ in xs])
    E_true = []
    for _, _, R, t in xs:
        T = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        E = T @ R
        E_true.append(E / np.linalg.norm(E))
    Es, ok = five_point.five_point_essential(torch.from_numpy(x1),
                                             torch.from_numpy(x2))
    jEs, jok = jax.vmap(jfive.five_point_essential)(jnp.asarray(x1),
                                                    jnp.asarray(x2))
    return (x1, x2, np.stack(E_true), Es.numpy(), ok.numpy(),
            np.asarray(jEs), np.asarray(jok))


def test_null_space_spans_the_svd_null_space(minimal_samples):
    """Householder on A^T (in float64, as the solver runs it) gives an
    orthonormal basis of the null space that float64 SVD gives, closer to
    it than JAX's float32 SVD is."""
    x1, x2 = minimal_samples[:2]
    u1, v1, u2, v2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    A = np.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                  np.ones_like(u1)], -1)
    N = five_point._null_space_5x9(torch.from_numpy(A).double()).numpy()
    Vt = np.asarray(jax.vmap(lambda a: jnp.linalg.svd(
        a, full_matrices=True)[2][5:])(jnp.asarray(A)))
    V64 = np.linalg.svd(A.astype(np.float64))[2][:, 5:]
    np.testing.assert_allclose(N @ N.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(4), (N_SAMPLES, 4, 4)),
                               atol=1e-12)

    def proj(M):
        return M.transpose(0, 2, 1) @ M

    port = np.abs(proj(N) - proj(V64)).max()
    ref = np.abs(proj(Vt.astype(np.float64)) - proj(V64)).max()
    assert port < 1e-7 and port < ref, (port, ref)


def _best_to(Es, ok, E):
    return min([min(np.linalg.norm(e - E), np.linalg.norm(e + E))
                for e in Es[ok]] or [np.inf])


def test_five_point_recovers_truth_as_often_as_jax(minimal_samples):
    """Within 2e-2 of the true E (tests/test_essential.py's bar): the port
    as often as JAX, within 3 of 64 samples, and in at least 40 % of
    them (JAX's own docstring: ~65 % of minimal samples)."""
    _, _, E_true, Es, ok, jEs, jok = minimal_samples
    port = sum(_best_to(Es[i], ok[i], E_true[i]) < 2e-2
               for i in range(N_SAMPLES))
    ref = sum(_best_to(jEs[i], jok[i], E_true[i]) < 2e-2
              for i in range(N_SAMPLES))
    assert port >= ref - 3 and port >= 0.4 * N_SAMPLES, (port, ref)


def test_five_point_candidates_are_essential(minimal_samples):
    """Every candidate marked ok is unit-norm, satisfies the five epipolar
    constraints, det E = 0 and the trace constraint as tightly as JAX's
    candidates do (within 10x JAX's worst residual, or 1e-4)."""
    x1, x2, _, Es, ok, jEs, jok = minimal_samples

    def residuals(E, i):
        h1 = np.concatenate([x1[i], np.ones((5, 1), np.float32)], 1)
        h2 = np.concatenate([x2[i], np.ones((5, 1), np.float32)], 1)
        epi = np.abs(np.einsum("ni,ij,nj->n", h2, E, h1)).max()
        EEt = E @ E.T
        trace = np.abs(2 * EEt @ E - np.trace(EEt) * E).max()
        return np.array([epi, abs(np.linalg.det(E)), trace])

    def worst(Es_, ok_):
        return np.max([residuals(Es_[i, j].astype(np.float64), i)
                       for i in range(N_SAMPLES) for j in range(10)
                       if ok_[i, j]], axis=0)

    assert ok.any(axis=1).mean() > 0.9
    np.testing.assert_allclose(np.linalg.norm(Es[ok], axis=(1, 2)), 1.0,
                               atol=1e-5)
    got, ref = worst(Es, ok), worst(jEs, jok)
    assert (got <= np.maximum(10 * ref, 1e-4)).all(), (got, ref)


def test_five_point_batched_over_hypotheses(minimal_samples):
    """Any leading shape: a (2, 32) batch gives (2, 32, 10) candidates, as
    good as the flat batch's (within 2 samples on the ground truth; the
    float32 elimination amplifies reduction-order rounding, so slots are
    not compared)."""
    x1, x2, E_true, Es, ok = minimal_samples[:5]
    Eb, okb = five_point.five_point_essential(
        torch.from_numpy(x1).reshape(2, 32, 5, 2),
        torch.from_numpy(x2).reshape(2, 32, 5, 2))
    assert Eb.shape == (2, 32, 10, 3, 3) and okb.shape == (2, 32, 10)
    Eb, okb = Eb.reshape(64, 10, 3, 3).numpy(), okb.reshape(64, 10).numpy()
    hits = [sum(_best_to(E[i], o[i], E_true[i]) < 2e-2 for i in range(64))
            for E, o in ((Eb, okb), (Es, ok))]
    assert abs(hits[0] - hits[1]) <= 2, hits
    one, ok1 = five_point.five_point_essential(torch.from_numpy(x1[7]),
                                               torch.from_numpy(x2[7]))
    assert one.shape == (10, 3, 3) and ok1.shape == (10,)


# --- eigen-decomposition, 8-point polish, decomposition -----------------------


@pytest.mark.parametrize("n", [3, 9])
def test_sym_eig_matches_lapack(n):
    rng = np.random.default_rng(n)
    A = rng.normal(size=(32, n, n)).astype(np.float32)
    S = A @ A.transpose(0, 2, 1)
    w, V = essential.sym_eig(torch.from_numpy(S))
    wr, Vr = np.linalg.eigh(S.astype(np.float64))
    assert np.abs(w.numpy() - wr).max() < 1e-5 * np.abs(wr).max()
    d = np.minimum(np.abs(V.numpy() - Vr).max(axis=1),
                   np.abs(V.numpy() + Vr).max(axis=1))
    assert d.max() < 1e-4


@pytest.fixture(scope="module")
def polish_inputs():
    out = []
    for s in range(6):
        uv1, uv2, _, _ = make_two_view(200, s, noise=0.3)
        w = (np.random.default_rng(s).random(200) > 0.2).astype(np.float32)
        out.append((_normalized(uv1), _normalized(uv2), w))
    return out


def _up_to_sign(a, b):
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def test_eight_point_matches_jax(polish_inputs):
    for x1, x2, w in polish_inputs:
        ref = np.asarray(jess._eight_point(jnp.asarray(x1), jnp.asarray(x2),
                                           jnp.asarray(w)))
        t = [torch.from_numpy(a) for a in (x1, x2, w)]
        got = essential._eight_point(*t).numpy()
        f64 = essential._eight_point(*(a.double() for a in t)).numpy()
        assert _up_to_sign(got, ref) < EIGHT_POINT_TOL
        assert _up_to_sign(got, f64) < EIGHT_POINT_F64_TOL
        s = np.linalg.svd(got.astype(np.float64), compute_uv=False)
        assert abs(s[0] - s[1]) < 1e-5 and s[2] < 1e-5


def test_decompose_and_vote_matches_jax(polish_inputs):
    for x1, x2, w in polish_inputs:
        E = np.asarray(jess._eight_point(jnp.asarray(x1), jnp.asarray(x2),
                                         jnp.asarray(w)))
        Rj, tj = jess._decompose_and_vote(jnp.asarray(E), jnp.asarray(x1),
                                          jnp.asarray(x2), jnp.asarray(w))
        R, t = essential._decompose_and_vote(
            *(torch.from_numpy(a) for a in (E, x1, x2, w)))
        assert np.abs(R.numpy() - np.asarray(Rj)).max() < 1e-5
        assert np.abs(t.numpy() - np.asarray(tj)).max() < 1e-5


# --- RANSAC ------------------------------------------------------------------


#: RANSAC with JAX's draws: the winning rotations (rad) and inlier masks
#: (share of the valid points). Both polish with a float32 8-point solve,
#: whose rotation lies up to 2.3e-3 rad from the float64 polish on the same
#: inliers in JAX itself; measured over seeds 1-6: up to 2.44e-3 rad and
#: 13 of 228 points (8pt, seed 2, where the hypotheses part ways)
RANSAC_ROT_TOL = 5e-3
RANSAC_MASK_FRAC = 0.06


@pytest.mark.parametrize("solver", ["5pt", "8pt"])
@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_find_essential_ransac_matches_jax(solver, seed):
    """JAX's draws fed to the port: the two winning rotations within
    RANSAC_ROT_TOL, the inlier masks equal but for RANSAC_MASK_FRAC of the
    points; both within 1 degree of the truth."""
    uv1, uv2, R_gt, _ = make_two_view(256, seed, noise=0.3,
                                      outlier_frac=0.2)
    valid = np.ones(256, bool)
    valid[::9] = False
    key = jax.random.PRNGKey(seed)
    ref = jess.find_essential_ransac(jnp.asarray(uv1), jnp.asarray(uv2),
                                     jnp.asarray(valid), FX, PP, key,
                                     solver=solver)
    u = np.asarray(jax.random.uniform(key, (200, 256)))
    got = essential.find_essential_ransac(
        torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(valid),
        FX, PP, uniforms=torch.from_numpy(u), solver=solver)
    assert _angle(np.asarray(ref.R), got.R.numpy()) <= RANSAC_ROT_TOL
    differ = (np.asarray(ref.inliers) != got.inliers.numpy()).sum()
    assert differ <= RANSAC_MASK_FRAC * valid.sum(), differ
    assert np.degrees(_angle(R_gt, got.R.numpy())) < 1.0
    assert not got.inliers.numpy()[~valid].any()


def test_find_essential_ransac_batched_and_drawn():
    """B = 2 sequences with their own generators give what two single calls
    with those generators give; a solver name it does not know raises."""
    views = [make_two_view(128, s, noise=0.3, outlier_frac=0.2)
             for s in (4, 5)]
    p1 = torch.from_numpy(np.stack([v[0] for v in views]))
    p2 = torch.from_numpy(np.stack([v[1] for v in views]))
    valid = torch.ones(2, 128, dtype=torch.bool)
    gens = [pipeline.seeded_generator(b, "cpu") for b in (0, 1)]
    got = essential.find_essential_ransac(p1, p2, valid, FX, PP,
                                          generator=gens)
    for b in range(2):
        one = essential.find_essential_ransac(
            p1[b], p2[b], valid[b], FX, PP,
            generator=pipeline.seeded_generator(b, "cpu"))
        np.testing.assert_allclose(got.R[b].numpy(), one.R.numpy(), atol=1e-6)
        np.testing.assert_array_equal(got.inliers[b].numpy(),
                                      one.inliers.numpy())
    with pytest.raises(ValueError, match="solver"):
        essential.find_essential_ransac(p1[0], p2[0], valid[0], FX, PP,
                                        generator=gens[0], solver="7pt")


# --- the mono step -------------------------------------------------------------

H, W = 120, 160
INTR = dict(fx=120.0, fy=120.0, cx=W / 2, cy=H / 2, bf=-120.0 * 0.54,
            width=W, height=H)
RANSAC = 200
ESS_ITERS = 200


def _numpy_state(st):
    def image(im):
        return {"pyramid": [np.asarray(p) for p in im.pyramid],
                "shapes": im.shapes, "pad": im.pad}

    return {"features": {k: np.asarray(v)
                         for k, v in st.features._asdict().items()},
            "lk_l0": image(st.lk_l0), "lk_r0": image(st.lk_r0),
            "tvec": np.asarray(st.tvec)}


@pytest.fixture(scope="module")
def mono_course():
    seq = SyntheticStereoSequence(CameraIntrinsics(**INTR), num_frames=7,
                                  seed=0, speed=0.5)
    return [seq.frame(i) for i in range(len(seq))]


def test_mono_step_parity_with_jax(mono_course):
    """JAX's mono step over frames 1-3, its state carried into the port,
    then frames 4-5 in both, the port fed JAX's two draws a frame (PnP's,
    then the essential RANSAC's)."""
    frames = mono_course
    jcfg = JVOConfig.for_image(H, W, ransac_iterations=RANSAC,
                               mono_rotation=True)
    cfg = VOConfig.for_image(H, W, ransac_iterations=RANSAC,
                             mono_rotation=True)
    jstep = jax_make_step(jcfg, JIntrinsics(**INTR))
    step = pipeline.make_step_fn(cfg, CameraIntrinsics(**INTR), device="cpu")
    jst = jax_init(jcfg, JIntrinsics(**INTR), *frames[0])
    for i in (1, 2, 3):
        jst, _ = jstep(jst, *(jnp.asarray(x) for x in frames[i]))
    st = state_from_numpy(_numpy_state(jst), device="cpu")
    for i in (4, 5):
        key, sub = jax.random.split(jst.key)
        _, sub2 = jax.random.split(key)
        u = torch.tensor(np.asarray(jax.random.uniform(
            sub, (RANSAC, cfg.padded_features))))
        ue = torch.tensor(np.asarray(jax.random.uniform(
            sub2, (ESS_ITERS, cfg.padded_features))))
        jst, ref = jstep(jst, *(jnp.asarray(x) for x in frames[i]))
        st, got = step(st, *(torch.from_numpy(x) for x in frames[i]),
                       uniforms=u, ess_uniforms=ue)
        assert int(got.num_bucketed) == int(ref.num_bucketed)
        for name in ("num_matched", "num_inliers"):
            r, g = int(getattr(ref, name)), int(getattr(got, name))
            assert abs(g - r) <= COUNT_FRAC * r, (name, g, r)
        assert bool(got.accept) == bool(ref.accept)
        d = np.abs(got.T_inv.numpy() - np.asarray(ref.T_inv))
        assert d[:3, :3].max() < ROT_TOL and d[:3, 3].max() < TRANS_TOL
        # the rotation is the essential matrix's, not PnP's
        assert np.abs(got.rvec.numpy() - np.asarray(ref.rvec)).max() < ROT_TOL


def test_mono_step_batched_equals_single(mono_course):
    """B = 2 in lockstep (the same course, shifted by one frame) against
    per-sequence steps; sequence b draws from its own generator, PnP's
    draw first, then the essential RANSAC's."""
    frames = mono_course
    cfg = VOConfig.for_image(H, W, ransac_iterations=RANSAC,
                             mono_rotation=True)
    intr = CameraIntrinsics(**INTR)
    seqs = [frames[0:4], frames[1:5]]
    step = pipeline.make_step_fn(cfg, intr, device="cpu")
    lefts = np.stack([s[0][0] for s in seqs])
    rights = np.stack([s[0][1] for s in seqs])
    bst = batch.batched_init_state(cfg, lefts, rights, seed=0, device="cpu")
    bouts = []
    for i in (1, 2, 3):
        bst, out = step(bst, torch.from_numpy(np.stack([s[i][0] for s in seqs])),
                        torch.from_numpy(np.stack([s[i][1] for s in seqs])))
        bouts.append(out)
    for b, s in enumerate(seqs):
        st = pipeline.init_vo_state(cfg, intr, *s[0], seed=b, device="cpu")
        for i in (1, 2, 3):
            st, ref = step(st, *(torch.from_numpy(x) for x in s[i]))
            got = bouts[i - 1]
            assert int(got.num_inliers[b]) == int(ref.num_inliers)
            assert bool(got.accept[b]) == bool(ref.accept)
            d = np.abs(got.T_inv[b].numpy() - ref.T_inv.numpy())
            assert d[:3, :3].max() < ROT_TOL and d[:3, 3].max() < TRANS_TOL


def test_mono_rotation_mode_runs():
    """tests/test_e2e.py::test_mono_rotation_mode_runs through the port's
    ``run_sequence_scan``."""
    intr = CameraIntrinsics(**INTR)
    cfg = VOConfig.for_image(H, W, ransac_iterations=100, mono_rotation=True)
    seq = SyntheticStereoSequence(intr, num_frames=6, seed=3, speed=0.5)
    poses, fetched, _, n = pipeline.run_sequence_scan(
        iter(seq), cfg, intr, chunk=5, warmup=False, device="cpu")
    assert n == 5
    assert np.mean(fetched.accept) >= 0.6
    assert ate_rmse(seq.poses[:len(poses)], poses) < 0.3


# ---- the JAX package's CPU reference for chip_smoke.py's phase 8 ----------

def jax_course_reference(mode: str, steps: int, height: int = 376,
                         width: int = 1241):
    """The JAX package on the CPU over ``steps`` steps of the bench's
    "straight" course at its camera, with ``mono_rotation=True`` (``mode``
    "mono") or ``detector="shi-tomasi"``: accept ratio, rejected frames
    and ATE against the bench's budget (bench.py:145-150), as
    chip_smoke.py's phase 8 runs the port::

        PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_essential.py mono 64
        PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_essential.py shi-tomasi 64
    """
    import time

    from bench import _kitti_intrinsics
    from visual_odom_tpu.io.synthetic import make_course
    from visual_odom_tpu.runner.pipeline import run_sequence_scan

    opts = ({"mono_rotation": True} if mode == "mono"
            else {"detector": "shi-tomasi"})
    jintr = _kitti_intrinsics(height, width)
    seq = make_course("straight", jintr, num_frames=steps + 1)
    frames = [seq.frame(i) for i in range(steps + 1)]
    gt = seq.poses
    t = time.perf_counter()
    poses, fetched, _, n = run_sequence_scan(
        frames, JVOConfig.for_image(height, width, **opts), jintr, chunk=16)
    err = np.linalg.norm(poses[:len(gt), :3, 3] - gt[:, :3, 3], axis=1)
    course_len = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0),
                                             axis=1)))
    accept = np.asarray(fetched.accept, bool)
    return {"course": "straight", "mode": mode, "image": f"{width}x{height}",
            "steps": n, "seconds": time.perf_counter() - t,
            "accept": float(accept.mean()),
            "rejected_frames": [int(i) + 1 for i in np.flatnonzero(~accept)],
            "ate_m": float(np.sqrt(np.mean(err ** 2))),
            "ate_budget_m": 0.01 * course_len,
            "mean_inliers": float(np.mean(fetched.num_inliers))}


if __name__ == "__main__":
    import json
    import sys

    print(json.dumps(jax_course_reference(sys.argv[1], int(sys.argv[2]))))
