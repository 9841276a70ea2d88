"""PnP-RANSAC's refinement entry points on the CPU: ``refine_hypotheses``
and ``refine_polish`` take their plain twins there and launch nothing, and
the CUDA wrappers refuse what their kernels (csrc/pnp_gn.cu) do not take
before any launch. The kernels themselves are held to the plain twins on
the card (tests/test_torch_cuda.py)."""

import pytest
import torch

from visual_odom_tpu_torch.backend import pnp
from visual_odom_tpu_torch.core.lie import rodrigues, rodrigues_inverse
from visual_odom_tpu_torch.io.pnp_scene import pnp_scene
from visual_odom_tpu_torch.utils import cudagraph

torch.set_num_threads(1)

K = torch.tensor([[718.856, 0.0, 607.1928], [0.0, 718.856, 185.2157],
                  [0.0, 0.0, 1.0]])


def _scene(B, n=64, hyps=20, k=6, seed=0):
    return pnp_scene("cpu", B, n, hyps, k, K, seed)


def test_scene_is_seeded_and_shaped_as_the_kernels_take_it():
    """One seed gives one scene; each tensor is contiguous and of the dtype
    and shape the kernels take; every sample lies on valid slots, and the
    polish weights only valid slots."""
    a, b = _scene(2, seed=3), _scene(2, seed=3)
    assert all(torch.equal(a[key], b[key]) for key in a)
    assert not torch.equal(a["X"], _scene(2, seed=4)["X"])
    shapes = dict(pose0=(2, 6), X=(2, 64, 3), x=(2, 64, 2), K=(3, 3),
                  idx=(2, 20, 6), polish=(2, 6), w=(2, 64), valid=(2, 64))
    for key, shape in shapes.items():
        assert tuple(a[key].shape) == shape and a[key].is_contiguous()
    assert a["idx"].dtype == torch.int64 and a["valid"].dtype == torch.bool
    assert torch.equal(a["K"], K)
    assert bool(torch.take_along_dim(a["valid"][:, None], a["idx"],
                                     dim=2).all())
    assert bool((a["w"] <= a["valid"]).all())


@pytest.fixture
def no_library(monkeypatch):
    """Any load of the kernels' library fails the test."""
    def refuse():
        raise AssertionError("the PnP kernels' library was loaded")

    monkeypatch.setattr(pnp, "_library", refuse)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_cpu_route_is_the_plain_twin_and_launches_nothing(no_library,
                                                          batched):
    """On the CPU ``pnp_ransac`` refines through the plain twins: the
    hypotheses as the gather, parity starts and ``_gn_refine`` written out,
    bit for bit, and no launch counted."""
    d = _scene(3 if batched else 1)
    before = cudagraph.launch_counts()
    got = pnp.refine_hypotheses(d["pose0"], d["X"], d["x"], d["idx"], K, 6)
    B, H, k = d["idx"].shape
    starts = torch.where((torch.arange(H) % 2 == 0)[:, None],
                         d["pose0"][:, None], torch.zeros(B, 1, 6))
    idx = d["idx"][..., None]
    want = pnp._gn_refine(
        starts.reshape(B * H, 6),
        torch.take_along_dim(d["X"][:, None], idx, dim=2).reshape(-1, k, 3),
        torch.take_along_dim(d["x"][:, None], idx, dim=2).reshape(-1, k, 2),
        torch.ones(B * H, k), K, 6)
    assert torch.equal(got, want)
    polished = pnp.refine_polish(d["pose0"], d["X"], d["x"], d["w"], K, 12)
    assert torch.equal(polished, pnp._gn_refine(d["pose0"], d["X"], d["x"],
                                                d["w"], K, 12))
    g = [torch.Generator().manual_seed(b) for b in range(B)]
    if batched:
        res = pnp.pnp_ransac(d["X"], d["x"], d["valid"], K, torch.zeros(3),
                             d["pose0"][:, 3:], generator=g, iterations=20)
    else:
        res = pnp.pnp_ransac(d["X"][0], d["x"][0], d["valid"][0], K,
                             torch.zeros(3), d["pose0"][0, 3:],
                             generator=g[0], iterations=20)
    assert bool(torch.isfinite(res.tvec).all())
    after = cudagraph.launch_counts()
    assert after["pnp_hypotheses"] == before["pnp_hypotheses"]
    assert after["pnp_polish"] == before["pnp_polish"]


def test_hypotheses_start_from_the_warm_start_or_the_identity():
    """With no iteration a hypothesis is its start pose through the
    Rodrigues round trip: pose0[b] for even h, the identity for odd h."""
    d = _scene(2, hyps=5)
    d["pose0"][:, :3] = torch.tensor([[0.01, -0.02, 0.03], [0.2, 0.1, -0.1]])
    got = pnp.refine_hypotheses(d["pose0"], d["X"], d["x"], d["idx"], K,
                                0).reshape(2, 5, 6)
    trip = torch.cat([rodrigues_inverse(rodrigues(d["pose0"][:, :3])),
                      d["pose0"][:, 3:]], dim=-1)
    assert torch.equal(got[:, 0::2], trip[:, None].expand(2, 3, 6))
    assert torch.equal(got[:, 1::2], torch.zeros(2, 2, 6))


def test_entry_points_refuse_other_devices():
    d = {k: v.to("meta") for k, v in _scene(1).items()}
    with pytest.raises(ValueError, match="no PnP refinement for device meta"):
        pnp.refine_hypotheses(d["pose0"], d["X"], d["x"], d["idx"],
                              K.to("meta"), 6)
    with pytest.raises(ValueError, match="no PnP refinement for device meta"):
        pnp.refine_polish(d["pose0"], d["X"], d["x"], d["w"], K.to("meta"),
                          12)


def test_launch_counters_are_the_wrappers():
    """``utils.cudagraph`` reads and sets both kernels' counts on their
    wrappers, as it does the LK kernels'."""
    before = cudagraph.launch_counts()
    assert before["pnp_hypotheses"] == pnp.refine_hypotheses.launches
    assert before["pnp_polish"] == pnp.refine_polish.launches
    try:
        cudagraph.add_launches({"pnp_hypotheses": 2, "pnp_polish": 3})
        assert pnp.refine_hypotheses.launches == before["pnp_hypotheses"] + 2
        assert pnp.refine_polish.launches == before["pnp_polish"] + 3
    finally:
        cudagraph.set_launch_counts(before)
    assert cudagraph.launch_counts() == before


def _hyp_args(d):
    return dict(pose0=d["pose0"], points3d=d["X"], points2d=d["x"],
                sample_idx=d["idx"], K=K)


def _pol_args(d):
    return dict(pose6=d["pose0"], X=d["X"], x_obs=d["x"], w=d["w"], K=K)


#: (entry point, argument, how it is spoiled, what the error says)
BAD = {
    "pose0_float64": ("hyp", "pose0", lambda t: t.double(), "pose0: expected"),
    "points3d_width": ("hyp", "points3d", lambda t: t[..., :2].contiguous(),
                       "points3d: expected"),
    "points2d_batch": ("hyp", "points2d", lambda t: t[:1], "points2d: expected"),
    "idx_int32": ("hyp", "sample_idx", lambda t: t.int(), "sample_idx: expected"),
    "idx_rank": ("hyp", "sample_idx", lambda t: t[0], "sample_idx \\(B, H, k\\)"),
    "idx_strided": ("hyp", "sample_idx", lambda t: t.transpose(1, 2).contiguous(
        ).transpose(1, 2), "sample_idx must be contiguous"),
    "hyp_K_float64": ("hyp", "K", lambda t: t.double(), "K: expected"),
    "hyp_no_sample": ("hyp", "sample_idx", lambda t: t[..., :0],
                      "empty refinement"),
    "pose6_shape": ("pol", "pose6", lambda t: t[:, :3].contiguous(),
                    "pose6: expected"),
    "X_strided": ("pol", "X", lambda t: t.transpose(0, 1).contiguous(
        ).transpose(0, 1), "X must be contiguous"),
    "x_obs_float16": ("pol", "x_obs", lambda t: t.half(), "x_obs: expected"),
    "w_bool": ("pol", "w", lambda t: t > 0, "w: expected"),
    "w_shape": ("pol", "w", lambda t: t[:, :-1].contiguous(), "w: expected"),
    "pol_K_shape": ("pol", "K", lambda t: t[:2].contiguous(), "K: expected"),
    "pol_no_points": ("pol", "X", lambda t: t[:, :0], "empty refinement"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_cuda_wrappers_refuse_before_any_launch(no_library, case):
    """Each CUDA wrapper checks dtype, shape and contiguity (and then the
    device) before it loads or launches anything."""
    which, name, spoil, message = BAD[case]
    d = _scene(2)
    args = _hyp_args(d) if which == "hyp" else _pol_args(d)
    args[name] = spoil(args[name])
    launch = (pnp._refine_hypotheses_cuda if which == "hyp"
              else pnp._refine_polish_cuda)
    with pytest.raises(ValueError, match=message):
        launch(*args.values(), 6, 1e-3)


@pytest.mark.parametrize("which", ["hyp", "pol"])
def test_cuda_wrappers_refuse_cpu_tensors_and_negative_iterations(no_library,
                                                                  which):
    d = _scene(2)
    args = _hyp_args(d) if which == "hyp" else _pol_args(d)
    launch = (pnp._refine_hypotheses_cuda if which == "hyp"
              else pnp._refine_polish_cuda)
    with pytest.raises(ValueError, match="iters must be >= 0"):
        launch(*args.values(), -1, 1e-3)
    with pytest.raises(ValueError, match="take CUDA tensors"):
        launch(*args.values(), 6, 1e-3)
