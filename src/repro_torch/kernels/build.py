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
the main path went through.  A kernel with variants (``vwr_matmul``:
split-K, wgmma, the WMMA / FMA tile kernel; ``vwr_swiglu``: wgmma or the
WMMA / FMA tile kernel;
``vwr_conv2d``: wgmma or the halo-tile kernel;
``vwr_mla_flash_decode``, ``vwr_mla_paged_flash_decode``,
``vwr_mla_chunk_prefix_attend`` and their ``_q8`` siblings: wgmma or
FMA;
``vwr_flash_decode`` and its ``_q8`` sibling: split-KV on mma.sync or
FMA; ``vwr_paged_flash_decode`` and its ``_q8`` sibling: split-KV on
mma.sync or FMA;
``vwr_chunk_prefix_attend`` and its ``_q8`` sibling: wgmma or FMA;
``vwr_depthwise``: row-streamed
strips or the halo tile) also counts the variant that ran in
``VARIANTS``.
"""
from __future__ import annotations

import contextlib
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
SOURCES = ("vwr_matmul", "vwr_attention", "vwr_decode", "vwr_paged_decode",
           "vwr_chunk_prefix", "vwr_mla_decode", "vwr_conv2d",
           "vwr_depthwise")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {"vwr_matmul": 0, "vwr_swiglu": 0,
                            "vwr_attention": 0, "vwr_flash_decode": 0,
                            "vwr_paged_flash_decode": 0,
                            "vwr_paged_flash_decode_q8": 0,
                            "vwr_chunk_prefix_attend": 0,
                            "vwr_chunk_prefix_attend_q8": 0,
                            "vwr_mla_flash_decode": 0,
                            "vwr_mla_paged_flash_decode": 0,
                            "vwr_mla_paged_flash_decode_q8": 0,
                            "vwr_mla_flash_decode_q8": 0,
                            "vwr_flash_decode_q8": 0,
                            "vwr_mla_chunk_prefix_attend": 0,
                            "vwr_mla_chunk_prefix_attend_q8": 0,
                            "vwr_conv2d": 0, "vwr_depthwise": 0}

VARIANTS: Dict[str, int] = {"vwr_matmul.splitk": 0, "vwr_matmul.wgmma": 0,
                            "vwr_matmul.gemm": 0, "vwr_swiglu.wgmma": 0,
                            "vwr_swiglu.gemm": 0,
                            "vwr_conv2d.wgmma": 0, "vwr_conv2d.tile": 0,
                            "vwr_mla_flash_decode.wgmma": 0,
                            "vwr_mla_flash_decode.fma": 0,
                            "vwr_mla_paged_flash_decode.wgmma": 0,
                            "vwr_mla_paged_flash_decode.fma": 0,
                            "vwr_mla_chunk_prefix_attend.wgmma": 0,
                            "vwr_mla_chunk_prefix_attend.fma": 0,
                            "vwr_mla_chunk_prefix_attend_q8.wgmma": 0,
                            "vwr_mla_chunk_prefix_attend_q8.fma": 0,
                            "vwr_flash_decode.split": 0,
                            "vwr_flash_decode.fma": 0,
                            "vwr_flash_decode_q8.split": 0,
                            "vwr_flash_decode_q8.fma": 0,
                            "vwr_chunk_prefix_attend.wgmma": 0,
                            "vwr_chunk_prefix_attend.fma": 0,
                            "vwr_chunk_prefix_attend_q8.wgmma": 0,
                            "vwr_chunk_prefix_attend_q8.fma": 0,
                            "vwr_paged_flash_decode.mma": 0,
                            "vwr_paged_flash_decode.fma": 0,
                            "vwr_paged_flash_decode_q8.mma": 0,
                            "vwr_paged_flash_decode_q8.fma": 0,
                            "vwr_mla_paged_flash_decode_q8.wgmma": 0,
                            "vwr_mla_paged_flash_decode_q8.fma": 0,
                            "vwr_mla_flash_decode_q8.wgmma": 0,
                            "vwr_mla_flash_decode_q8.fma": 0,
                            "vwr_depthwise.stream": 0,
                            "vwr_depthwise.tile": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}


# open ``uncounted()`` blocks
_UNCOUNTED = 0


def count_launch(kernel: str, variant: Optional[str] = None) -> None:
    if _UNCOUNTED:
        return
    LAUNCHES[kernel] += 1
    if variant is not None:
        VARIANTS[f"{kernel}.{variant}"] += 1


@contextlib.contextmanager
def uncounted():
    """Launches inside are not counted: the autotuner's timing launches
    are not work that a path did."""
    global _UNCOUNTED
    _UNCOUNTED += 1
    try:
        yield
    finally:
        _UNCOUNTED -= 1


def reset_launches() -> None:
    for counts in (LAUNCHES, VARIANTS):
        for k in counts:
            counts[k] = 0


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


_SPLIT_COUNTERS: Dict[object, object] = {}


def split_counters(device, stream: int, n: int):
    """A zeroed int32 buffer of at least ``n`` counters for launches on
    ``stream`` (the handle ``stream_of`` gives) on ``device``, for the
    kernels whose K splits are summed by the last block of a tile
    (``vwr_matmul``'s split-K and wgmma variants, ``vwr_swiglu``'s and
    ``vwr_conv2d``'s wgmma variants) or whose key splits are merged by the
    last block of a row group (``vwr_flash_decode``'s and its ``_q8``
    sibling's split variants, ``vwr_paged_flash_decode``'s mma variant,
    ``vwr_chunk_prefix_attend``'s and its ``_q8`` sibling's,
    ``vwr_mla_flash_decode``'s and ``vwr_mla_paged_flash_decode``'s and
    their ``_q8`` siblings' wgmma variants), kept across calls: every
    launch leaves its counters at 0.  A buffer belongs to one stream, and
    so does a CUDA graph captured on it: launches on one stream run in
    order and share it, launches on
    two streams get two buffers and cannot race on them."""
    import torch

    key = (device, stream)
    buf = _SPLIT_COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _SPLIT_COUNTERS[key] = buf
    return buf


_SPLIT_WORKSPACE: Dict[object, object] = {}


def split_workspace(device, stream: int, n: int):
    """An fp32 buffer of at least ``n`` floats for the key splits'
    partials of launches on ``stream`` on ``device`` (``vwr_flash_decode``'s
    and its ``_q8`` sibling's split variants, ``vwr_paged_flash_decode``'s
    mma variant, ``vwr_chunk_prefix_attend``'s and its ``_q8`` sibling's
    and the MLA decode kernels' wgmma variants), kept across calls and
    grown (doubled) when a call needs more: a launch writes every partial
    it reads.  A buffer belongs to one stream, as ``split_counters``'s
    does; it is allocated while that stream is current, so the caching
    allocator frees a grown-out buffer only after the launches already
    queued on that stream."""
    import torch

    key = (device, stream)
    buf = _SPLIT_WORKSPACE.get(key)
    if buf is None or buf.numel() < n:
        size = max(n, 2 * (0 if buf is None else buf.numel()), 1 << 16)
        buf = torch.empty(size, dtype=torch.float32, device=device)
        _SPLIT_WORKSPACE[key] = buf
    return buf


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
