"""Build, load and launch the port's hand-written CUDA kernels.

Each ``se_tpu_torch/csrc/<name>.cu`` has a plain C interface and may
include the shared ``csrc/*.cuh`` headers.  At first use it is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<digest>.so``
beside the package (the digest covers the source, the headers and the
flags, so an edited source builds anew) and loaded with ``ctypes``
(``ops/compile.py`` runs the compilers).  Nothing is compiled when a module
is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
from pathlib import Path

import torch

from .compile import compile_all

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, per kernel
)

_LOADED: dict = {}


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")
    return path


def build(names=None) -> dict:
    """Compile the named kernels (default: every source in ``csrc/``) that
    are not built yet, one ``nvcc`` each, all started together.  Returns
    ``{name: compiler output}`` for the ones compiled; raises if any fails."""
    names = kernel_names() if names is None else list(names)
    return compile_all({name: ([_nvcc(), *NVCC_FLAGS, str(CSRC_DIR / f"{name}.cu")],
                            library_path(name)) for name in names}, "kernel")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.  Every
    library exports ``se_cuda_error_string`` (``csrc/error_string.cuh``)."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.se_cuda_error_string.argtypes = [ctypes.c_int]
        lib.se_cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


# The workspace of the backward kernels' split reductions (dW, dbias:
# csrc/lstm_common.cuh), in floats: each segment of rows sums into a
# partial there, and a split is cut to fit it.  16 MiB holds the splits of
# every shape the paths run.
DW_WORKSPACE_FLOATS = 1 << 22


def dw_workspace(dev) -> torch.Tensor:
    """A workspace for the split reductions on ``dev``."""
    return torch.empty(DW_WORKSPACE_FLOATS, device=dev, dtype=torch.float32)


# The stream dtypes of the hand kernels' two forms, and the suffix of each
# form's C entry (se_<kernel>_f32, se_<kernel>_bf16)
STREAM_FORMS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def check_dtypes(named, stream_dtype) -> None:
    """Raise unless ``stream_dtype`` is float32 or bfloat16 and each
    ``(name, tensor, is_stream)`` of ``named`` has ``stream_dtype`` where
    ``is_stream`` and float32 elsewhere (weights, carries, the stash)."""
    if stream_dtype not in STREAM_FORMS:
        raise TypeError(f"the input stream must be float32 or bfloat16, got {stream_dtype}")
    for name, t, is_stream in named:
        want = stream_dtype if is_stream else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")


def count_launch(fn, stream_dtype, form: str = "") -> None:
    """One launch of ``fn``'s kernel: ``fn.launches`` counts the f32 form,
    ``fn.launches_bf16`` the bf16-stream form; a ``form`` suffix (K2's
    bf16 cell-state stash: ``"_cs16"``) counts on ``fn.launches<form>`` and
    ``fn.launches_bf16<form>``."""
    attr = ("launches_bf16" if stream_dtype == torch.bfloat16 else "launches") + form
    setattr(fn, attr, getattr(fn, attr) + 1)


def cuda_launch(lib, fn_name, tensors, names, outs, dims, dev, dtypes=None):
    """Check the inputs' device, type and contiguity, launch
    ``lib.<fn_name>(*inputs, *outs, *dims, device, stream)`` on the current
    stream, and raise on a CUDA error.  ``dtypes`` gives each input's
    expected dtype (default: float32 for all); ``outs`` may hold None for a
    null pointer."""
    if dev.type != "cuda":
        raise ValueError(f"{fn_name} runs on cuda or cpu, not {dev}")
    dtypes = (torch.float32,) * len(tensors) if dtypes is None else dtypes
    for name, t, dtype in zip(names, tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    ptrs = [t.data_ptr() for t in tensors] + [
        None if o is None else o.data_ptr() for o in outs
    ]
    rc = getattr(lib, fn_name)(
        *ptrs, *dims, index, torch.cuda.current_stream(dev).cuda_stream
    )
    if rc:
        msg = lib.se_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {rc} ({msg})")
