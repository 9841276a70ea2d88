"""``ctypes`` binding to the repo's native host runtime (``native/``).

The port's counterpart of ``visual_odom_tpu/io/native.py``: PNG grayscale
decode (reference src/utils.cpp:172-190), a multithreaded lookahead
prefetcher for streaming a dataset, and Y8I stereo deinterlace / V4L2
capture (reference src/rgbd_standalone.cpp).

The library is built from ``native/png_decode.cpp``, ``prefetch.cpp`` and
``v4l2_capture.cpp`` with ``native/Makefile``'s flags into
``visual_odom_tpu_torch/_build/libcvo_native-<hash>.so``, where the hash
covers the sources and the flags: an edited source is rebuilt and a stale
library is never loaded. The compiler writes a temporary file that is then
moved into place, so processes that build at once never load a torn
library, and nothing is written into ``native/``. ``CVO_NATIVE_LIB`` may
name a library to load first. The library is loaded with ``ctypes.CDLL``,
which releases the GIL during each call, so decode threads overlap the
caller's Python. Nothing here runs at import time.

``load_library()`` raises when the library cannot be had (no compiler, or
the compiler's output when the build fails); ``available()`` is the quiet
probe that ``io.kitti`` uses to pick its decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("png_decode.cpp", "prefetch.cpp", "v4l2_capture.cpp")
HEADERS = ("cvo_native.h",)
#: native/Makefile's CXXFLAGS, LDFLAGS and LDLIBS
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared", "-pthread")
LIBS = ("-lz",)

_lib = None
_lib_error: Optional[ImportError] = None
_lib_lock = threading.Lock()


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha1(" ".join(CXX_FLAGS + LIBS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR,
                        f"libcvo_native-{digest.hexdigest()[:12]}.so")


def build_library() -> str:
    """Compile the library unless its current build exists; return its
    path. Raises ImportError without a compiler or the sources, and with
    the compiler's output when the build fails."""
    try:
        path = library_path()
    except OSError as e:
        raise ImportError(f"native sources missing under {NATIVE_DIR}: "
                          f"{e}") from e
    if os.path.exists(path):
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise ImportError("no C++ compiler (g++, or $CXX) to build the native "
                          "runtime")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", tmp,
         *(os.path.join(NATIVE_DIR, s) for s in SOURCES), *LIBS],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise ImportError(f"building the native runtime failed:\n"
                          f"{proc.stdout}")
    os.replace(tmp, path)
    return path


def _declare(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.cvo_png_info.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int32),
                                 ctypes.POINTER(ctypes.c_int32)]
    lib.cvo_png_info.restype = ctypes.c_int
    lib.cvo_decode_png_gray.argtypes = [ctypes.c_char_p, u8p, ctypes.c_size_t]
    lib.cvo_decode_png_gray.restype = ctypes.c_int
    lib.cvo_decode_png_gray_mem.argtypes = [
        u8p, ctypes.c_size_t, u8p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.cvo_decode_png_gray_mem.restype = ctypes.c_int
    lib.cvo_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32]
    lib.cvo_prefetcher_create.restype = ctypes.c_void_p
    lib.cvo_prefetcher_height.argtypes = [ctypes.c_void_p]
    lib.cvo_prefetcher_height.restype = ctypes.c_int32
    lib.cvo_prefetcher_width.argtypes = [ctypes.c_void_p]
    lib.cvo_prefetcher_width.restype = ctypes.c_int32
    lib.cvo_prefetcher_next.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.cvo_prefetcher_next.restype = ctypes.c_int64
    lib.cvo_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.cvo_prefetcher_destroy.restype = None
    lib.cvo_deinterlace_y8i.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32,
                                        u8p, u8p]
    lib.cvo_deinterlace_y8i.restype = None
    lib.cvo_v4l2_open.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                  ctypes.c_int32, ctypes.c_int32]
    lib.cvo_v4l2_open.restype = ctypes.c_void_p
    lib.cvo_v4l2_grab.argtypes = [ctypes.c_void_p, u8p, u8p]
    lib.cvo_v4l2_grab.restype = ctypes.c_int
    lib.cvo_v4l2_close.argtypes = [ctypes.c_void_p]
    lib.cvo_v4l2_close.restype = None


def _load(path: str):
    lib = ctypes.CDLL(path)
    _declare(lib)
    return lib


def load_library(build: bool = True):
    """The loaded library: ``$CVO_NATIVE_LIB`` if it names one that loads,
    else the port's own build, compiled first unless ``build`` is false
    (then only an existing build loads). Thread-safe and memoized, a
    failed build included; raises ImportError saying why the runtime is
    unavailable."""
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_error is not None:
            raise _lib_error
        env = os.environ.get("CVO_NATIVE_LIB")
        if env and os.path.exists(env):
            try:
                _lib = _load(env)
                return _lib
            except OSError:
                pass
        try:
            path = build_library() if build else library_path()
            _lib = _load(path)
        except (ImportError, OSError) as e:
            err = e if isinstance(e, ImportError) else ImportError(
                f"native runtime failed to load: {e}")
            if build:
                _lib_error = err
            raise err from None
        return _lib


def available(build: bool = True) -> bool:
    """Whether the native runtime can be loaded (built first if ``build``);
    never raises."""
    try:
        load_library(build)
    except ImportError:
        return False
    return True


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_png_gray(path: str) -> np.ndarray:
    """Decode one PNG to (H, W) uint8 grayscale with the native decoder
    (BT.601 fixed-point weights for colour; the high byte of 16-bit)."""
    lib = load_library()
    h, w = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.cvo_png_info(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise OSError(-rc, f"cvo_png_info failed on {path}")
    out = np.empty((h.value, w.value), np.uint8)
    rc = lib.cvo_decode_png_gray(path.encode(), _u8ptr(out), out.size)
    if rc != 0:
        raise OSError(-rc, f"cvo_decode_png_gray failed on {path}")
    return out


def deinterlace_y8i(interleaved: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(left, right) (H, W) planes from an (H, W, 2) Y8I uint8 buffer (low
    byte left, high byte right)."""
    lib = load_library()
    buf = np.ascontiguousarray(interleaved, np.uint8)
    if not (buf.ndim == 3 and buf.shape[-1] == 2):
        raise ValueError("expected (H, W, 2) interleaved Y8I")
    h, w = buf.shape[:2]
    left = np.empty((h, w), np.uint8)
    right = np.empty((h, w), np.uint8)
    lib.cvo_deinterlace_y8i(_u8ptr(buf), h, w, _u8ptr(left), _u8ptr(right))
    return left, right


class PrefetchingLoader:
    """In-order multithreaded PNG stream (the native lookahead ring).
    Iterating yields (frame_index, image); every file must have the first
    one's size."""

    def __init__(self, paths: Sequence[str], n_threads: int = 4,
                 capacity: int = 8):
        lib = load_library()
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.cvo_prefetcher_create(
            arr, len(self._paths), n_threads, capacity)
        if not self._handle:
            raise OSError(f"prefetcher failed to open {paths[0]!r}")
        self.height = lib.cvo_prefetcher_height(self._handle)
        self.width = lib.cvo_prefetcher_width(self._handle)

    def next_frame(self) -> Optional[tuple[int, np.ndarray]]:
        """The next (index, image), or None at the end; raises OSError on a
        file that does not decode."""
        out = np.empty((self.height, self.width), np.uint8)
        idx = self._lib.cvo_prefetcher_next(self._handle, _u8ptr(out),
                                            out.size)
        if idx == -1:
            return None
        if idx < 0:
            raise OSError(int(-idx), "native decode failed mid-sequence")
        return int(idx), out

    def __iter__(self):
        while True:
            item = self.next_frame()
            if item is None:
                return
            yield item

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.cvo_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeV4L2Camera:
    """Y8I stereo capture through the native V4L2 unit (reference
    src/rgbd_standalone.cpp: /dev/video1, 640x480, 10 frames discarded)."""

    def __init__(self, device: str = "/dev/video1", width: int = 640,
                 height: int = 480, discard: int = 10):
        lib = load_library()
        self._lib = lib
        self.width, self.height = width, height
        self._handle = lib.cvo_v4l2_open(device.encode(), width, height,
                                         discard)
        if not self._handle:
            raise OSError(f"cannot open V4L2 device {device}")

    def get_lr_frames(self) -> tuple[np.ndarray, np.ndarray]:
        left = np.empty((self.height, self.width), np.uint8)
        right = np.empty((self.height, self.width), np.uint8)
        rc = self._lib.cvo_v4l2_grab(self._handle, _u8ptr(left), _u8ptr(right))
        if rc != 0:
            raise OSError(-rc, "V4L2 grab failed")
        return left, right

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.cvo_v4l2_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
