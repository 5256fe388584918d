"""ctypes bindings of the host C++ of the data pipeline
(`pillarnet_lts_torch/csrc/pillar_pipeline.cpp`).

The port's counterpart of `pillarnet_lts_tpu/native`, with its API: each
function returns None (`draw_gaussians`: False) when the library is not
there, and its caller (`core/bbox/box_np_ops.py`) then takes its numpy
route. The library is built at first use with the host compiler (`CXX`,
else `g++`) and the flags of the repository's `csrc/Makefile`, into the
git-ignored `build/pillarnet_lts_torch/` that the CUDA kernels use
(`ops/_kernels.py`); its file name carries a hash of the source, the
compiler, the flags and the host CPU (`-march=native` code runs only on
the CPU it was built for), so nothing stale or foreign loads. A failed
build is kept: `build_error()` returns the compiler's stderr.

Nothing is built or loaded on import; the first call does it, once per
process, under a lock (the data loader's threads call in together).
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "pillar_pipeline.cpp")
# the directory `ops/_kernels.py` builds the CUDA kernels into
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "pillarnet_lts_torch")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LD_FLAGS = ("-shared", "-pthread")
BUILD_TIMEOUT = 300  # s

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.c_int64
_SIGNATURES = {
    "points_in_rbbox": [_F32P, _I64, _I64, _F32P, _I64, _I64, _U8P],
    "draw_gaussians": [_F32P, _I64, _I64, _F32P, _I32P, _I64,
                       ctypes.c_float],
    "box_collision_test": [_F32P, _I64, _F32P, _I64, _U8P],
    "transform_sweep": [_F32P, _I64, _I64, _F32P, ctypes.c_float, _F32P],
}

_lock = threading.Lock()
_state = {"tried": False, "lib": None, "error": None}


def _host_cpu():
    """The lines of /proc/cpuinfo that name the CPU and its instruction
    sets (empty where the file does not exist)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        return ""
    keep = [ln for ln in lines
            if ln.split(":")[0].strip() in ("model name", "flags",
                                            "Features", "CPU part")]
    return "\n".join(sorted(set(keep)))


def library_path(cxx=None):
    """Where the library of this source, compiler and host CPU lives."""
    cxx = cxx or os.environ.get("CXX", "g++")
    digest = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS + LD_FLAGS).encode())
    digest.update(_host_cpu().encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libpillar_pipeline-{digest.hexdigest()[:16]}.so")


def build_library():
    """Compile the source into `library_path()` unless it is there;
    returns the path. Raises RuntimeError with the compiler's stderr."""
    cxx = os.environ.get("CXX", "g++")
    out = library_path(cxx)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp,
                                   *LD_FLAGS], capture_output=True,
                                  text=True, timeout=BUILD_TIMEOUT)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{cxx} could not build {SOURCE}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build {SOURCE} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: no process loads half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load():
    with _lock:
        if not _state["tried"]:
            _state["tried"] = True
            try:
                lib = ctypes.CDLL(build_library())
            except (RuntimeError, OSError) as e:
                _state["error"] = str(e)
            else:
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = None
                _state["lib"] = lib
        return _state["lib"]


def available():
    """Whether the library is built and loaded (builds it on first call)."""
    return _load() is not None


def build_error():
    """Why the library is not there: the compiler's stderr or the load
    error of the first attempt; None when it loaded (or was not tried)."""
    _load()
    return _state["error"]


def _fptr(a):
    return a.ctypes.data_as(_F32P)


def _u8ptr(a):
    return a.ctypes.data_as(_U8P)


def points_in_rbbox(points, boxes):
    """(P, N) bool: point p in box b (x, y, z, w, l, h, ..., yaw; centred
    boxes, faces included, in f32); None without the library or boxes."""
    lib = _load()
    if lib is None or boxes.shape[0] == 0:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32)
    bxs = np.ascontiguousarray(boxes, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] < 3 or bxs.ndim != 2 \
            or bxs.shape[1] < 7:
        raise ValueError(f"points (P, >=3) and boxes (N, >=7), got "
                         f"{pts.shape} and {bxs.shape}")
    out = np.empty((pts.shape[0], bxs.shape[0]), np.uint8)
    lib.points_in_rbbox(_fptr(pts), pts.shape[0], pts.shape[1], _fptr(bxs),
                        bxs.shape[0], bxs.shape[1], _u8ptr(out))
    return out.astype(bool)


def draw_gaussians(heatmap, centers, radii, k=1.0):
    """Stamp gaussians of `radii` at `centers` (n, 2) into the (H, W) f32
    heatmap in place (the elementwise max); False without the library."""
    lib = _load()
    if lib is None:
        return False
    if heatmap.dtype != np.float32 or not heatmap.flags.c_contiguous:
        raise ValueError("heatmap: a C-contiguous float32 (H, W) array")
    c = np.ascontiguousarray(centers, dtype=np.float32).reshape(-1, 2)
    r = np.ascontiguousarray(radii, dtype=np.int32).reshape(-1)
    if heatmap.ndim != 2 or len(r) != len(c):
        raise ValueError(f"heatmap (H, W), centers (n, 2), radii (n,); got "
                         f"{heatmap.shape}, {c.shape}, {r.shape}")
    lib.draw_gaussians(_fptr(heatmap), heatmap.shape[0], heatmap.shape[1],
                       _fptr(c), r.ctypes.data_as(_I32P), c.shape[0],
                       ctypes.c_float(k))
    return True


def box_collision_test(corners_a, corners_b):
    """(n, m) bool: BEV corner quads (n, 4, 2) and (m, 4, 2) collide; None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(corners_a, dtype=np.float32)
    b = np.ascontiguousarray(corners_b, dtype=np.float32)
    if a.shape[1:] != (4, 2) or b.shape[1:] != (4, 2):
        raise ValueError(f"corners (n, 4, 2), got {a.shape} and {b.shape}")
    out = np.empty((a.shape[0], b.shape[0]), np.uint8)
    lib.box_collision_test(_fptr(a), a.shape[0], _fptr(b), b.shape[0],
                           _u8ptr(out))
    return out.astype(bool)


def transform_sweep(points, tf, time_lag):
    """(n, C) sweep points -> (n, C + 1): xyz moved by the 4x4 `tf` (None:
    as they are), the other columns copied, `time_lag` appended; None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(points, dtype=np.float32)
    tf_arr = None if tf is None else np.ascontiguousarray(tf,
                                                          dtype=np.float32)
    if src.ndim != 2 or src.shape[1] < 3 or (
            tf_arr is not None and tf_arr.shape != (4, 4)):
        raise ValueError(f"points (n, >=3) and tf (4, 4) or None, got "
                         f"{src.shape}, {tf if tf is None else tf_arr.shape}")
    dst = np.empty((src.shape[0], src.shape[1] + 1), np.float32)
    lib.transform_sweep(_fptr(src), src.shape[0], src.shape[1],
                        None if tf_arr is None else _fptr(tf_arr),
                        ctypes.c_float(time_lag), _fptr(dst))
    return dst
