"""Build, load and count the port's hand-written CUDA kernels.

Each source under `pillarnet_lts_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into its own shared library with a plain C interface (no PyTorch
headers, so a build takes seconds) and loaded with `ctypes`. The build
happens at first use, into `build/pillarnet_lts_torch/` beside the package;
the library file name carries a hash of the source and the flags, so an
edited source never loads a stale library. A failed build raises with
nvcc's stderr; nothing falls back.

The kernels launch only from the CUDA implementations of their custom ops
(`ops/library.py`, `torch.ops.pillarnet.*`), which eager calls and exported
programs both reach. `LAUNCHES` counts kernel launches per kernel: each op
adds one right after its launch succeeds and nowhere else, so a caller can
zero the counts, run the model and see which kernels the run went through.
An op that calls two entry points of one source (the sorted-run
scatter-max makes its sort keys first) counts once, as its kernel; the int8
conv's and the fused stage's bf16 and f32 variants (`int8_conv` /
`int8_conv_f32`, `int8_stage` / `int8_stage_f32`, one source each) count
apart; an entry point that only exposes a kernel's staged values for
a check (`suppression_mask_corners`) counts nothing.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

LAUNCHES = {"pillar_scatter_max": 0, "pillar_scatter_max_tiled": 0,
            "rotated_overlap": 0, "suppression_mask": 0, "int8_conv": 0,
            "int8_conv_f32": 0, "int8_stage": 0, "int8_stage_f32": 0}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "pillarnet_lts_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int

# -fmad=false: with a*b+c contracted to FMA a kernel no longer repeats its
# plain version's roundings: the overlap drifts up to 3.7e-4 m^2 on +-54 m
# boxes (H100 run), the suppression mask would flip on pairs at the
# threshold, and the int8 dequant (acc * dq + shift) moves by a bf16 ulp
# now and then
_NO_FMA = ("-fmad=false",)

# kernel -> (source file, extra nvcc flags, C symbol, argtypes)
KERNELS = {
    "pillar_scatter_max": (
        "pillar_scatter_max.cu", (), "pillar_scatter_max",
        [_P] * 6 + [_I64] * 4 + [_INT, _P],
    ),
    "pillar_scatter_max_tiled": (
        "pillar_scatter_max_tiled.cu", (), "pillar_scatter_max_sorted",
        [_P] * 8 + [_I64] * 4 + [_INT, _P],
    ),
    "pillar_scatter_max_tiled_keys": (
        "pillar_scatter_max_tiled.cu", (), "pillar_scatter_max_sorted_keys",
        [_P] * 3 + [_I64] * 3 + [_P],
    ),
    "rotated_overlap": (
        "rotated_overlap.cu", _NO_FMA, "rotated_overlap_f32",
        [_P, _P, _P, _I64, _I64, _I64, _P],
    ),
    "suppression_mask": (
        "suppression_mask.cu", _NO_FMA, "suppression_mask_f32",
        [_P, _P, ctypes.c_float, _P, _I64, _I64, _I64, _P],
    ),
    "suppression_mask_corners": (
        "suppression_mask.cu", _NO_FMA, "suppression_mask_corners_f32",
        [_P, _P, _P, _I64, _I64, _P],
    ),
    "int8_conv": (
        "int8_conv.cu", _NO_FMA, "int8_conv_bf16",
        [_P] * 8 + [_INT] * 9 + [_P],
    ),
    "int8_conv_f32": (
        "int8_conv.cu", _NO_FMA, "int8_conv_f32",
        [_P] * 8 + [_INT] * 9 + [_P],
    ),
    "int8_stage": (
        "int8_stage.cu", _NO_FMA, "int8_stage_bf16",
        [_P] * 7 + [_INT] * 4 + [_P],
    ),
    "int8_stage_f32": (
        "int8_stage.cu", _NO_FMA, "int8_stage_f32",
        [_P] * 7 + [_INT] * 4 + [_P],
    ),
}

_lock = threading.Lock()
_loaded = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def build_library(source, extra_flags=()):
    """Compile one `csrc/` source into a shared library; returns its path.

    Reuses a library built from the same source bytes, headers (`csrc/
    *.cuh`) and flags."""
    src = os.path.join(CSRC_DIR, source)
    flags = list(NVCC_FLAGS) + list(extra_flags)
    digest = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {source} (exit {proc.returncode}):\n"
                f"{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see a stub
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def kernel(name):
    """The C entry point of kernel `name`, built and loaded on first use."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            source, extra, symbol, argtypes = KERNELS[name]
            fn = getattr(ctypes.CDLL(build_library(source, extra)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn


def build_all():
    """Build every kernel library, one nvcc per source, all at once, then
    load every kernel (what first calls would do)."""
    from concurrent.futures import ThreadPoolExecutor

    libs = {(src, extra) for src, extra, _, _ in KERNELS.values()}
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(build_library, *lib) for lib in libs]:
            f.result()
    for name in KERNELS:
        kernel(name)


def raise_on_error(name, err):
    """Raise on a failed launch (the C entry returns its cudaError_t)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def launched(name, err):
    """Raise on a failed launch, else count it."""
    raise_on_error(name, err)
    LAUNCHES[name] += 1


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stream_handle(device):
    """The current CUDA stream of `device` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_device(name, t):
    """Raise unless `t` lies on the CPU (the plain version) or on a CUDA
    device (the kernel): the kernel ops' wrappers take no other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: expected CPU or CUDA tensors, got "
                         f"{t.device}")


def check_args(name, align=1, **tensors):
    """Wrapper checks shared by the kernels: one CUDA device, contiguous,
    and each data pointer a multiple of `align` bytes (vector loads)."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: expected tensors on one CUDA device, "
                         f"got {devices}")
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name}: {arg} must be {align}-byte aligned")
