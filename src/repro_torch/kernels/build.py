"""Build and load the port's CUDA kernels at first use.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, compiled by `nvcc -gencode arch=compute_90a,code=sm_90a` and
loaded with ctypes. All sources compile in parallel (one nvcc process
each) the first time any kernel is needed, into
`<repo>/build/kernels/<hash>/`, where the hash covers every file under
`csrc/` (sources and any header they include) and the compiler flags
(hw.py's kernel constants among them), so an edited kernel is
rebuilt and a clean checkout builds everything from the repository
alone. Nothing here runs at import time; a missing nvcc or a failed
compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from repro_torch import hw

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("bcq_matmul", "paged_attention")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              # the GEMM's tile constants, written once in hw.py
              f"-DBCQ_GEMM_COLS={hw.GEMM_COLS}",
              f"-DBCQ_GEMM_TILE_MAX={hw.GEMM_TILE_MAX}",
              f"-DBCQ_GEMM_PAIRED_TILE={hw.GEMM_PAIRED_TILE}",
              # the GEMV's block shape and the attention's partition
              f"-DBCQ_GEMV_COLS={hw.GEMV_COLS}",
              f"-DBCQ_GEMV_WARPS={hw.GEMV_WARPS}",
              f"-DPA_TILE={hw.ATTN_TILE}",
              f"-DPA_MAX_CLUSTER={hw.ATTN_MAX_CLUSTER}",
              f"-DPA_MAX_REP={hw.ATTN_MAX_REP}",
              f"-DPA_MAX_STAGES={hw.ATTN_MAX_STAGES}",
              f"-DPA_QUANT_SCALES_MAX={hw.ATTN_QUANT_SCALES_MAX}")

_LIBS: dict = {}
_FUNCS: dict = {}


def _nvcc() -> str:
    """nvcc from CUDA_HOME, PATH, or PyTorch's own CUDA_HOME probe."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cands.append(Path(CUDA_HOME) / "bin" / "nvcc")
    for c in cands:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are compiled at first use")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(CSRC)).encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every missing library of the current sources, all nvcc
    processes started together; returns the build directory. The
    compiler's output (ptxas register and spill report) is kept in
    `<name>.log` beside each library."""
    out = build_dir()
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        log = open(out / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, log, p in procs:
        rc = p.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out / f"lib{name}.so")
        else:
            failed.append(f"{name}.cu (exit {rc}):\n"
                          + (out / f"{name}.log").read_text()[-4000:])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building all sources on the
    first call in this process."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
    return lib


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """A C launch function of csrc/<lib_name>.cu with its argument types
    declared (pointers and the stream as c_void_p), returning int."""
    key = (lib_name, fn_name)
    fn = _FUNCS.get(key)
    if fn is None:
        fn = getattr(library(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C launch function."""
    if status:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError "
                           f"{status}")
