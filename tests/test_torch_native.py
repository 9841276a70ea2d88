"""The port's native runtime binding and KITTI reader against the JAX
package's, byte for byte.

The counterparts of tests/test_native.py and of the PNG half of
tests/test_fault_injection.py:

- ``decode_png_gray`` equals JAX's on gray, RGB, RGBA and 16-bit PNGs
  (and the RGB case equals OpenCV's BT.601 fixed-point weights);
- ``cvo_png_info`` reads a header and refuses a missing or foreign file;
- the prefetcher delivers every frame in order, then the end;
- ``deinterlace_y8i`` equals ``V4L2StereoCamera.split_y8i`` and JAX's;
- ``KittiSequence``'s ``frame``, ``__iter__`` and ``iter_prefetched``
  equal JAX's on one directory, and a missing or truncated PNG ends the
  plain and the prefetched stream where JAX's ends;
- the library is built into the port's ``_build/`` under a hash of its
  sources and flags, never into ``native/``.

The tests that need the C++ toolchain skip inside a fixture where there is
no ``g++``.
"""

import ctypes
import os
import shutil

import numpy as np
import pytest
import torch

from visual_odom_tpu.io import camera as jcamera
from visual_odom_tpu.io import kitti as jkitti
from visual_odom_tpu.io import native as jnative
from visual_odom_tpu_torch.io import camera, kitti, native

torch.set_num_threads(1)


@pytest.fixture
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain to build the native runtime")
    lib = native.load_library()
    if not jnative.available():
        pytest.skip("the JAX package's native runtime did not build")
    return lib


def _write_png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)  # L / RGB / RGBA / I;16 from the dtype


def _images(seed):
    rng = np.random.default_rng(seed)
    return {
        "gray": rng.integers(0, 256, (37, 53), np.uint8),
        "rgb": rng.integers(0, 256, (41, 29, 3), np.uint8),
        "rgba": rng.integers(0, 256, (16, 16, 4), np.uint8),
        "gray16": rng.integers(0, 65536, (12, 18), np.uint16),
    }


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "gray16"])
def test_decode_equals_jax(lib, tmp_path, kind):
    img = _images(0)[kind]
    p = str(tmp_path / f"{kind}.png")
    _write_png(p, img)
    got = native.decode_png_gray(p)
    want = jnative.decode_png_gray(p)
    assert got.dtype == np.uint8 and got.shape == img.shape[:2]
    np.testing.assert_array_equal(got, want)
    if kind == "gray":
        np.testing.assert_array_equal(got, img)
    if kind == "rgb":
        r, g, b = (img[..., i].astype(np.int64) for i in range(3))
        ref = (r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14
        np.testing.assert_array_equal(got, ref.astype(np.uint8))


def test_png_info_and_errors(lib, tmp_path):
    p = str(tmp_path / "z.png")
    _write_png(p, np.zeros((5, 7), np.uint8))
    h, w = ctypes.c_int32(), ctypes.c_int32()
    assert lib.cvo_png_info(p.encode(), ctypes.byref(h), ctypes.byref(w)) == 0
    assert (h.value, w.value) == (5, 7)
    assert lib.cvo_png_info(b"/nonexistent.png", ctypes.byref(h),
                            ctypes.byref(w)) < 0
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all, certainly not enough")
    assert lib.cvo_png_info(str(bad).encode(), ctypes.byref(h),
                            ctypes.byref(w)) < 0
    with pytest.raises(OSError):
        native.decode_png_gray(str(bad))
    with pytest.raises(OSError):
        jnative.decode_png_gray(str(bad))


def test_prefetcher_in_order_delivery(lib, tmp_path):
    rng = np.random.default_rng(3)
    frames, paths = [], []
    for i in range(20):
        img = rng.integers(0, 256, (24, 32), np.uint8)
        img[0, 0] = i
        p = str(tmp_path / f"{i:06d}.png")
        _write_png(p, img)
        frames.append(img)
        paths.append(p)
    loader = native.PrefetchingLoader(paths, n_threads=4, capacity=5)
    assert (loader.height, loader.width) == (24, 32)
    for want in range(20):
        idx, img = loader.next_frame()
        assert idx == want
        np.testing.assert_array_equal(img, frames[want])
    assert loader.next_frame() is None
    loader.close()
    assert [i for i, _ in native.PrefetchingLoader(paths, n_threads=2)] \
        == list(range(20))


def test_deinterlace_equals_split_and_jax(lib):
    packed = np.random.default_rng(4).integers(0, 65536, (8, 10), np.uint16)
    left_ref, right_ref = camera.V4L2StereoCamera.split_y8i(packed)
    jl, jr = jcamera.V4L2StereoCamera.split_y8i(packed)
    inter = np.stack([(packed & 0xFF).astype(np.uint8),
                      (packed >> 8).astype(np.uint8)], axis=-1)
    left, right = native.deinterlace_y8i(inter)
    for got, want in ((left, left_ref), (right, right_ref), (left, jl),
                      (right, jr), (left, jnative.deinterlace_y8i(inter)[0]),
                      (right, jnative.deinterlace_y8i(inter)[1])):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        native.deinterlace_y8i(inter[..., 0])


def _kitti_dir(root, n=6, seed=5):
    rng = np.random.default_rng(seed)
    for d in ("image_0", "image_1"):
        os.makedirs(root / d)
    truth = []
    for i in range(n):
        pair = [rng.integers(0, 256, (20, 30), np.uint8) for _ in range(2)]
        for d, img in zip(("image_0", "image_1"), pair):
            _write_png(str(root / d / f"{i:06d}.png"), img)
        truth.append(pair)
    return truth


def _equal_streams(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for (al, ar), (bl, br) in zip(a, b):
        np.testing.assert_array_equal(al, bl)
        np.testing.assert_array_equal(ar, br)
    return len(a)


def test_kitti_sequence_equals_jax(lib, tmp_path):
    truth = _kitti_dir(tmp_path)
    seq = kitti.KittiSequence(str(tmp_path))
    jseq = jkitti.KittiSequence(str(tmp_path))
    assert len(seq) == len(jseq) == 6
    for i in (0, 3, 5):
        _equal_streams([seq.frame(i)], [jseq.frame(i)])
        _equal_streams([seq.frame(i)], [truth[i]])
    assert _equal_streams(seq, jseq) == 6
    assert _equal_streams(seq.iter_prefetched(n_threads=2, capacity=4),
                          jseq.iter_prefetched(n_threads=2, capacity=4)) == 6
    assert _equal_streams(seq.iter_prefetched(max_frames=3), truth[:3]) == 3
    with pytest.raises(FileNotFoundError):
        kitti.KittiSequence(str(tmp_path / "nowhere"))


@pytest.mark.parametrize("fault", ["missing_right", "truncated_left"])
@pytest.mark.parametrize("stream", ["plain", "prefetched"])
def test_bad_png_ends_stream_where_jax_does(lib, tmp_path, fault, stream):
    _kitti_dir(tmp_path)
    if fault == "missing_right":
        os.remove(tmp_path / "image_1" / "000003.png")
    else:
        bad = tmp_path / "image_0" / "000004.png"
        data = bad.read_bytes()
        bad.write_bytes(data[: len(data) // 3])

    def frames(mod):
        seq = mod.KittiSequence(str(tmp_path))
        return seq if stream == "plain" else seq.iter_prefetched()

    n = _equal_streams(frames(kitti), frames(jkitti))
    assert n == (3 if fault == "missing_right" else 4)


def test_library_builds_into_build_dir_under_its_hash(lib, tmp_path,
                                                      monkeypatch):
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.exists(path) and lib._name in (
        path, os.environ.get("CVO_NATIVE_LIB"))
    # a fresh build: one library under its hash, no temporary file left,
    # nothing of the port's written into native/
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    fresh = native.build_library()
    assert fresh == native.library_path()
    assert os.listdir(tmp_path / "build") == [os.path.basename(path)]
    assert not [f for f in os.listdir(native.NATIVE_DIR)
                if f.startswith("libcvo_native-") or ".tmp" in f]
    # the hash covers the flags
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != fresh


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-no-such-flag",))
    with pytest.raises(ImportError, match="no-such-flag"):
        native.build_library()
    assert os.listdir(tmp_path / "build") == []
