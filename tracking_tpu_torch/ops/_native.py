"""Build, load and count the port's CUDA kernels.

The kernels are CUDA C++ for Hopper (``sm_90a``) in ``tracking_tpu_torch/csrc``
with a plain C interface. On first use each source is compiled by its own
``nvcc`` process, all at once, and the objects are linked into one shared
library under ``build/tracking_tpu_torch/`` beside the package (the file
name carries a hash of the sources, so an edited source rebuilds), loaded
with ``ctypes``. Nothing here runs at import time: the CPU tests
import every module on a machine with no ``nvcc`` and no card.

Flags: ``-fmad=false`` and no fast math. The thresholds the kernels compute
are f32 expressions that the JAX reference evaluates without fused
multiply-adds; a contracted ``a*b+c`` moves a threshold by one unit.

Every wrapper adds one to its entry of :data:`LAUNCHES` where it launches its
kernel and nowhere else (:func:`count_launch`, under a lock: the shards of
``parallel.ShardGroup`` launch from several threads), so a run can show which
kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tracking_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

LAUNCHES = {
    "consensus": 0, "flood_reach": 0, "label_components": 0, "greedy_assign": 0,
    "consensus_lobster": 0, "gmg_step": 0, "texture_prox_cur": 0, "multilayer_step": 0,
    "consensus_read": 0, "consensus_feedback": 0, "fgd_tables": 0, "label_fixpoint": 0,
    "kalman_predict": 0, "kalman_update": 0, "contract": 0, "pca_project": 0, "syevd_small": 0,
}
_LAUNCH_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the kernels' entry points (csrc/*.cu); each returns the
# cudaError_t of its launches
_SIGNATURES = {
    "tt_consensus": [_P] * 22 + [_I] * 4 + [_F] * 3 + [_I] * 3 + [_P],
    "tt_flood_reach": [_P] * 4 + [_I] * 2 + [_P],
    "tt_label_components": [_P] * 2 + [_I] * 3 + [_P],
    "tt_label_fixpoint": [_P] * 4 + [_I] * 4 + [_P],
    "tt_greedy_assign": [_P] * 3 + [_I] * 2 + [_P],
    "tt_consensus_lobster": [_P] * 16 + [_I] * 4 + [_F] * 3 + [_I] * 6 + [_P],
    "tt_gmg_step": [_P] * 7 + [_I] * 3 + [_F] * 5 + [_I, _P],
    "tt_texture_prox_cur": [_P] * 4 + [_I] * 3 + [_P],
    "tt_multilayer_step": [_P] * 18 + [_I] * 3 + [_F] * 14 + [_P],
    "tt_consensus_read": [_P] * 17 + [_I] * 4 + [_F] * 3 + [_I] * 3 + [_P],
    "tt_consensus_feedback": [_P] * 2 + [_I] * 4 + [_F] * 3 + [_I] * 3 + [_P],
    "tt_fgd_tables": [_P] * 13 + [_I] * 9 + [_F] * 3 + [_P],
    "tt_kalman_predict": [_P] * 6 + [_I, _P],
    "tt_kalman_update": [_P] * 8 + [_I, _P],
    "tt_contract": [_P] * 8 + [_I] * 13 + [_P],
    "tt_contract_gram": [_P] * 4 + [_I] * 4 + [_P],
    "tt_contract_lift": [_P] * 4 + [_I] * 6 + [_P],
    "tt_pca_project": [_P] * 5 + [_I] * 2 + [_P],
    "tt_syevd_small": [_P] * 6 + [_I] * 3 + [_P],
    "tt_error_string": [_I],
}

_lib = None


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build(verbose: bool = False, force: bool = False) -> Path:
    """Compile csrc/*.cu into the shared library (once per source hash,
    or anew with ``force``): one ``nvcc -c`` per source, all started
    together, then one link."""
    digest = hashlib.sha256()
    for p in sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libtracking_tpu_torch_{digest.hexdigest()[:16]}.so"
    if out.exists() and not force:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + (["-Xptxas=-v"] if verbose else [])
    procs = [
        subprocess.Popen([nvcc, *compile_flags, "-c", "-o", str(o), str(s)], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for s, o in zip(srcs, objs)
    ]
    errors = []
    for s, proc in zip(srcs, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{s.name} ({proc.returncode}):\n{err}")
        elif verbose:
            print(f"{s.name}:\n{err}", end="")
    try:
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_char_p if name == "tt_error_string" else ctypes.c_int
        _lib = lib
    return _lib


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().tt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")


def require(t: torch.Tensor, name: str, dtype, shape=None, contiguous: bool = True) -> None:
    """Raise unless ``t`` is a CUDA tensor of ``dtype``/``shape`` on the
    current device (a kernel launches on the current device's stream: a
    rank bound to another card would pass it foreign pointers), contiguous
    unless the kernel takes its strides (``contiguous=False``)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: the tensor is on {t.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
