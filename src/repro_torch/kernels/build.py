"""Build and load the hand-written CUDA kernels.

Each ``repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds,
not minutes).  Libraries land in ``build/repro_torch/`` at the root of
the checkout, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.  ``build()`` compiles
every missing library at once, one ``nvcc`` process per source.

Nothing is built or loaded at import time: the first kernel launch (or
an explicit ``build()``) does it.  Each C entry point returns
``cudaGetLastError()`` after its launch; ``check`` raises on non-zero.

Every kernel wrapper adds one to its entry in ``LAUNCHES`` where it
launches its kernel, and nowhere else, so a run can show which kernels
the main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("vwr_matmul", "vwr_attention", "vwr_decode", "vwr_paged_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {"vwr_matmul": 0, "vwr_swiglu": 0,
                            "vwr_attention": 0, "vwr_flash_decode": 0,
                            "vwr_paged_flash_decode": 0,
                            "vwr_paged_flash_decode_q8": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}


def count_launch(kernel: str) -> None:
    LAUNCHES[kernel] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are compiled on the machine with the GPU")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES, *,
          ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes at once.  Returns each compiled source's
    compiler output (register and shared-memory use with
    ``ptxas_verbose``); raises with the compiler's errors if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        if ptxas_verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def kernel_fn(name: str, entry: str, argtypes):
    """(library, C entry point) with its ctypes prototype set; every
    entry point returns its ``cudaGetLastError()`` as an int."""
    lib = library(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# ---- operand checks shared by the kernel wrappers ----

_DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}   # csrc ReproDtype


def dtype_code(dtype) -> int:
    code = _DTYPE_CODES.get(str(dtype))
    if code is None:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"not {dtype}")
    return code


def check_operands(kernel: str, dtype, **operands) -> None:
    """Each operand is ``name=(tensor or None, expected shape)``.  Every
    tensor given must be a contiguous, 16-byte aligned CUDA tensor of
    ``dtype`` and that shape on the current device; raises otherwise."""
    import torch

    given = {n: ts for n, ts in operands.items() if ts[0] is not None}
    for name, (t, _) in given.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors (CPU tensors run "
                             "the plain version)")
    dev = torch.cuda.current_device()
    for name, (t, shape) in given.items():
        if t.device.index != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, not on "
                             f"the current CUDA device cuda:{dev}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, expected "
                            f"{dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous and "
                             "16-byte aligned")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def timed_build(names: Iterable[str] = SOURCES, *,
                ptxas_verbose: bool = False,
                log_dir: Optional[Path] = None) -> float:
    """``build`` and then load every library; returns the seconds it
    took.  With ``log_dir`` the compiler output of each source is
    written there as ``<name>.nvcc.txt``."""
    names = tuple(names)
    t0 = time.perf_counter()
    logs = build(names, ptxas_verbose=ptxas_verbose)
    for name in names:
        library(name)
    if log_dir is not None:
        log_dir.mkdir(parents=True, exist_ok=True)
        for name, text in logs.items():
            (log_dir / f"{name}.nvcc.txt").write_text(text)
    return time.perf_counter() - t0
