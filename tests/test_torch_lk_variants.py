"""The flag variants of the TPU quad kernel against the port's quad.

The JAX package's ``_legs_kernel`` has two bodies behind module flags:
``VO_LK_DOUBLESTEP`` (a second update on the already loaded J block while
floor(pt) stays put) and ``VO_LK_PACKED`` (four features' windows
lane-packed into one array). Both compute the default body's function. The
port's counterparts are instances of ``lk_quad_kernel`` (``doublestep``,
``packed``), held to the plain version ``lk_quad_plain`` on the card by
tests/test_torch_cuda.py and chip_smoke.py; here the plain version is held
to each JAX body, run as tests/test_lk_pallas.py runs it (interpret mode on
the CPU, the flag set on the module and every cache cleared around the
call), under the rule tests/test_torch_ops.py holds the default body to:
statuses equal, agreed tracks within PT_TOL.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import visual_odom_tpu.ops.lk_pallas as lkp
from conftest import make_textured_image, warp_translate
from visual_odom_tpu.ops.lk import LKParams as JLKParams
from visual_odom_tpu.ops.lk import prepare_lk_image as jax_prepare
from visual_odom_tpu_torch.ops import lk_cuda
from visual_odom_tpu_torch.ops.lk import LKImage, LKParams

# Small tensors: one intra-op thread each keeps the parallel test workers
# from oversubscribing the cores.
torch.set_num_threads(1)

#: |delta pt| bound on tracks whose status agrees (px)
PT_TOL = 1e-3
#: the JAX module flag of each variant
FLAGS = {"doublestep": "_DOUBLESTEP", "packed": "_PACKED"}
N = 32


def _clear_jax_caches():
    """The kernel builders cache on their arguments and the quad wrapper is
    jitted; the flags are module globals read at trace time."""
    lkp._build_legs_call.cache_clear()
    lkp._build_legs_call_batched.cache_clear()
    lkp._legs_chain.cache_clear()
    lkp.lk_circular_quad_pallas.clear_cache()


@pytest.fixture(scope="module")
def inputs():
    """L0 = I, R0 = J, R1 = I, L1 = J at 120x160 with J a (2.7, -1.9) px
    shift of I, N features (3 invalid) and seeds within +-1.5 px."""
    img0 = make_textured_image(120, 160, seed=17)
    img1 = warp_translate(img0, 2.7, -1.9)
    li = jax_prepare(jnp.asarray(img0), JLKParams())
    lj = jax_prepare(jnp.asarray(img1), JLKParams())
    rng = np.random.default_rng(4)
    pts = np.stack([rng.uniform(20, 140, N), rng.uniform(20, 100, N)],
                   axis=1).astype(np.float32)
    valid = np.ones(N, bool)
    valid[[3, 17, 30]] = False
    flow = rng.uniform(-1.5, 1.5, (N, 2)).astype(np.float32)
    disp = rng.uniform(-1.5, 1.5, (N, 2)).astype(np.float32)
    return li, lj, pts, valid, flow, disp


@pytest.fixture(scope="module")
def jax_variant_outputs(inputs):
    """Each JAX variant's quad at start levels 1 and 2, computed once."""
    li, lj, pts, valid, flow, disp = inputs
    outs = {}
    for variant, flag in FLAGS.items():
        old = getattr(lkp, flag)
        setattr(lkp, flag, True)
        _clear_jax_caches()
        try:
            for sl in (1, 2):
                res = lkp.lk_circular_quad_pallas(
                    li, lj, li, lj, jnp.asarray(pts), jnp.asarray(valid),
                    JLKParams(), interpret=True, flow=jnp.asarray(flow),
                    disp=jnp.asarray(disp), start_level=sl)
                outs[variant, sl] = [np.asarray(r) for r in res]
        finally:
            setattr(lkp, flag, old)
            _clear_jax_caches()
    return outs


def _port_quad(inputs, sl):
    li, lj, pts, valid, flow, disp = inputs
    ti, tj = (LKImage(tuple(torch.tensor(np.asarray(p)) for p in im.pyramid),
                      im.shapes, im.pad) for im in (li, lj))
    out = lk_cuda.lk_circular_quad(
        ti, tj, ti, tj, torch.from_numpy(pts), torch.from_numpy(valid),
        LKParams(), flow=torch.from_numpy(flow), disp=torch.from_numpy(disp),
        start_level=sl)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("start_level", [1, 2])
@pytest.mark.parametrize("variant", sorted(FLAGS))
def test_plain_quad_matches_jax_variant(inputs, jax_variant_outputs,
                                        variant, start_level):
    ref = jax_variant_outputs[variant, start_level]
    got = _port_quad(inputs, start_level)
    status = ref[4]
    np.testing.assert_array_equal(got[4], status)
    assert status.sum() > N // 2
    for g, r in zip(got[:4], ref[:4]):
        assert np.abs(g - r)[status].max() < PT_TOL
    # invalid slots pass their input through, as in the default body
    valid, pts = inputs[3], inputs[2]
    for r in ref[:4]:
        np.testing.assert_array_equal(r[~valid], pts[~valid])


def test_jax_flags_restored(jax_variant_outputs):
    """The fixture leaves the JAX module as it found it: later files on the
    same worker see the default body."""
    assert not lkp._DOUBLESTEP and not lkp._PACKED


@pytest.mark.parametrize("doublestep", [None, False, True])
@pytest.mark.parametrize("packed", [None, False, True])
def test_variant_resolves_defaults(doublestep, packed):
    got = lk_cuda.variant(doublestep, packed)
    assert got == (lk_cuda.DEFAULT_DOUBLESTEP if doublestep is None
                   else doublestep,
                   lk_cuda.DEFAULT_PACKED if packed is None else packed)


@pytest.mark.parametrize("bad", [0, 1, 2, "yes", np.bool_(True)])
def test_variant_rejects_what_the_kernels_are_not_built_for(bad):
    for kw in ({"doublestep": bad}, {"packed": bad}):
        with pytest.raises(ValueError, match="built for True or False"):
            lk_cuda.variant(**kw)


def test_variant_reads_no_environment(monkeypatch):
    monkeypatch.setenv("VO_LK_DOUBLESTEP", str(int(not lk_cuda.DEFAULT_DOUBLESTEP)))
    monkeypatch.setenv("VO_LK_PACKED", str(int(not lk_cuda.DEFAULT_PACKED)))
    assert lk_cuda.variant() == (lk_cuda.DEFAULT_DOUBLESTEP,
                                 lk_cuda.DEFAULT_PACKED)
