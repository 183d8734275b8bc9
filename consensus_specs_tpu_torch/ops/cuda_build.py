"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ctypes. Libraries are
named by a hash of their sources and flags, so an edited kernel is rebuilt
and a stale library is never loaded. Output goes to the package's
``_build/`` directory (gitignored).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
KERNELS = ("mont_mul", "pow_chain", "vm_step", "fq12_ladder", "fq12_fold",
           "miller_loop", "g1_fold", "scalar_mul")
_HEADERS = ("mont.cuh", "tower.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
# one build-and-load at a time: two threads of a process would otherwise
# write the same temporary library
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (f"{name}.cu",) + _HEADERS:
        with open(os.path.join(CSRC_DIR, fname), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def compile_sources(jobs: Dict[str, Tuple[str, str, Sequence[str]]]
                    ) -> Dict[str, str]:
    """Compile ``{name: (source, library, extra nvcc flags)}``, one ``nvcc``
    per source, all started together; each library appears whole or not
    at all. Returns {name: ptxas report}; raises with the compiler's output
    if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, (src, out, flags) in jobs.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, *flags, "-o", tmp, src]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing kernel library (``compile_sources``). Returns
    {name: ptxas report} for what was compiled."""
    return compile_sources({
        name: (os.path.join(CSRC_DIR, f"{name}.cu"), library_path(name), ())
        for name in names if not os.path.exists(library_path(name))})


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            _LOADED[name] = lib
        return lib
