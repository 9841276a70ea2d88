"""PyTorch port vs the JAX package: SO(3)/SE(3), the unrolled SPD solve,
DLT triangulation, PnP-RANSAC with injected draws, and the pose gates."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visual_odom_tpu.backend.integrate import gate_and_integrate as jax_gate
from visual_odom_tpu.backend.pnp import pnp_ransac as jax_pnp
from visual_odom_tpu.config import KITTI00
from visual_odom_tpu.core import lie as jlie
from visual_odom_tpu.core.linalg import solve_spd as jax_solve_spd
from visual_odom_tpu.core.triangulate import triangulate_points as jax_tri
from visual_odom_tpu_torch.backend.integrate import gate_and_integrate
from visual_odom_tpu_torch.backend.pnp import pnp_ransac
from visual_odom_tpu_torch.core import lie
from visual_odom_tpu_torch.core.linalg import solve_spd
from visual_odom_tpu_torch.core.triangulate import triangulate_points

# Small tensors: one intra-op thread each keeps the parallel test workers
# from oversubscribing the cores.
torch.set_num_threads(1)

#: relative tolerance of the float32 geometry kernels
REL = 1e-5
#: PnP pose tolerance (rvec rad, tvec m)
POSE_TOL = 1e-4


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref) / (np.abs(ref) + 1.0))


def _rvecs(kind, rng):
    axis = rng.normal(size=(64, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = {"small": rng.uniform(0, 1e-5, 64),
             "generic": rng.uniform(0.01, 3.0, 64),
             "near_pi": np.pi - rng.uniform(0, 5e-4, 64)}[kind]
    return (axis * angle[:, None]).astype(np.float32)


@pytest.mark.parametrize("kind", ["small", "generic", "near_pi"])
def test_rodrigues_and_inverse_match_jax(kind):
    rv = _rvecs(kind, np.random.default_rng(1))
    R_ref = np.asarray(jlie.rodrigues(jnp.asarray(rv)))
    R = lie.rodrigues(torch.from_numpy(rv)).numpy()
    assert _rel_err(R, R_ref) < REL
    w_ref = np.asarray(jlie.rodrigues_inverse(jnp.asarray(R_ref)))
    w = lie.rodrigues_inverse(torch.tensor(R_ref)).numpy()
    # near pi the log map is ill-conditioned (d theta ~ dR / sin theta)
    tol = REL if kind != "near_pi" else 2e-3
    assert _rel_err(w, w_ref) < tol


def test_euler_and_se3_match_jax():
    rng = np.random.default_rng(2)
    R = np.asarray(jlie.rodrigues(jnp.asarray(_rvecs("generic", rng))))
    t = rng.normal(size=(64, 3)).astype(np.float32)
    assert _rel_err(lie.rotation_to_euler(torch.from_numpy(R)).numpy(),
                    jlie.rotation_to_euler(jnp.asarray(R))) < REL
    T_ref = np.asarray(jlie.se3_inverse(jlie.se3_matrix(jnp.asarray(R),
                                                        jnp.asarray(t))))
    T = lie.se3_inverse(lie.se3_matrix(torch.from_numpy(R),
                                       torch.from_numpy(t))).numpy()
    assert _rel_err(T, T_ref) < REL


def test_solve_spd_matches_jax():
    rng = np.random.default_rng(3)
    M = rng.normal(size=(128, 6, 6)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(128, 6)).astype(np.float32)
    ref = np.asarray(jax_solve_spd(jnp.asarray(A), jnp.asarray(b)))
    got = solve_spd(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=REL, atol=REL * np.abs(ref).max())


def _stereo_points(n, seed):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-10, 10, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 40, n)], axis=1)
    Pl, Pr = KITTI00.proj_left().astype(np.float64), KITTI00.proj_right().astype(np.float64)
    Xh = np.concatenate([X, np.ones((n, 1))], axis=1)

    def proj(P):
        p = Xh @ P.T
        return (p[:, :2] / p[:, 2:]).astype(np.float32)

    return X.astype(np.float32), proj(Pl), proj(Pr)


def test_triangulation_matches_jax():
    """The float32 normal equations of the DLT amplify rounding: at KITTI
    baselines the JAX result itself lies up to ~3e-4 (relative) from the
    same method in float64. So the port is held to TRI_REL of JAX and to
    no more than twice JAX's own float32 error against float64."""
    TRI_REL = 1e-3
    X, xl, xr = _stereo_points(256, seed=4)
    Pl, Pr = KITTI00.proj_left(), KITTI00.proj_right()
    ref = np.asarray(jax_tri(jnp.asarray(Pl), jnp.asarray(Pr), jnp.asarray(xl),
                             jnp.asarray(xr)))
    args = [torch.from_numpy(a) for a in (Pl, Pr, xl, xr)]
    got = triangulate_points(*args).numpy()
    exact = triangulate_points(*(a.double() for a in args)).numpy()

    def rel(a, b):
        return np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)

    assert rel(got, ref).max() < TRI_REL
    assert rel(got, exact).max() <= 2.0 * rel(ref, exact).max() + 1e-6
    assert np.abs(ref - X).max() < 1e-2   # and both triangulate the scene


@pytest.mark.parametrize("outlier_frac", [0.0, 0.3])
def test_pnp_ransac_with_injected_draws_matches_jax(outlier_frac):
    """Same uniforms (drawn by JAX with the step's key split) -> same best
    hypothesis and inlier count, pose within POSE_TOL."""
    N, H = 256, 500
    rng = np.random.default_rng(5)
    X, _, _ = _stereo_points(N, seed=6)
    rv_true = np.array([0.01, -0.02, 0.005], np.float32)
    t_true = np.array([0.05, -0.02, 0.8], np.float32)
    R = np.asarray(jlie.rodrigues(jnp.asarray(rv_true)), np.float64)
    p = X @ R.T + t_true
    K = KITTI00.intrinsic_matrix()
    x = (p[:, :2] / p[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    x += rng.normal(0, 0.1, x.shape)
    bad = rng.random(N) < outlier_frac
    x[bad] += rng.uniform(-30, 30, (bad.sum(), 2))
    x = x.astype(np.float32)
    valid = rng.random(N) < 0.9
    tvec0 = np.array([0.0, 0.0, 0.7], np.float32)

    _, sub = jax.random.split(jax.random.PRNGKey(11))
    u = np.asarray(jax.random.uniform(sub, (H, N)))
    ref = jax_pnp(jnp.asarray(X), jnp.asarray(x), jnp.asarray(valid),
                  jnp.asarray(K), jnp.zeros(3, jnp.float32), jnp.asarray(tvec0),
                  sub, iterations=H, refine_iters=6)
    got = pnp_ransac(torch.from_numpy(X), torch.from_numpy(x),
                     torch.from_numpy(valid), torch.from_numpy(K),
                     torch.zeros(3), torch.from_numpy(tvec0),
                     iterations=H, refine_iters=6, uniforms=torch.from_numpy(u))
    assert int(got.best_hypothesis) == int(ref.best_hypothesis)
    assert int(got.num_inliers) == int(ref.num_inliers)
    assert int(ref.num_inliers) > 0.5 * valid.sum() * (1 - outlier_frac)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert np.abs(got.rvec.numpy() - np.asarray(ref.rvec)).max() < POSE_TOL
    assert np.abs(got.tvec.numpy() - np.asarray(ref.tvec)).max() < POSE_TOL


@pytest.mark.parametrize("rvec,tvec", [
    ((0.01, 0.02, -0.01), (0.1, 0.0, 0.9)),    # accepted
    ((0.0, 0.15, 0.0), (0.1, 0.0, 0.9)),       # rotation gate
    ((0.0, 0.01, 0.0), (0.0, 0.0, 0.01)),      # scale gate
])
def test_gate_matches_jax(rvec, tvec):
    rv, tv = np.float32(rvec), np.float32(tvec)
    ref = jax_gate(jnp.asarray(rv), jnp.asarray(tv))
    got = gate_and_integrate(torch.from_numpy(rv), torch.from_numpy(tv))
    assert bool(got.accept) == bool(ref.accept)
    assert _rel_err(got.T_inv.numpy(), ref.T_inv) < REL
    assert _rel_err(got.euler.numpy(), ref.euler) < REL
