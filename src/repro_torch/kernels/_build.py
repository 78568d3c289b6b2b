"""Build the port's CUDA kernels and load them with ctypes.

Three sources, one library each: `ell_spmv/csrc/ell_spmv.cu` (the graph
path's one-launch sliced-ELL pull sweep and the rectangular semiring
SpMV/SpMM), `flash_attention/csrc/flash_attention.cu` (the
LM prefill's attention: bf16 on wgmma fed by TMA, warp-specialised, and an
f32 FMA form; D in {32, 64, 128}) and `tc_matmul/csrc/tc_matmul.cu` (the
dense triangle count on int8 wgmma). The two tensor-core kernels share the
header `common/hopper.cuh` (tensor maps, mbarriers, TMA, wgmma,
setmaxnreg). Each source is compiled by `nvcc` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), for
`sm_90a`, on first use — never at import. The library lands in
`build/kernels/` at the root of the checkout (listed in `.gitignore`),
named by a hash of the source, the shared headers and the flags, so an
edited source or header rebuilds and an unchanged one is reused.
`build_all()` starts one `nvcc` per source, all at once, and returns each
compiler's `-Xptxas -v` report.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SOURCES = {name: _KERNELS / name / "csrc" / f"{name}.cu"
           for name in ("ell_spmv", "flash_attention", "tc_matmul")}
# headers the sources include; every library's hash covers them
HEADERS = tuple(sorted((_KERNELS / "common").glob("*.cuh")))

_LOADED: dict = {}   # name -> ctypes.CDLL, loaded once per process


def nvcc() -> str:
    """The CUDA compiler: `$CUDA_HOME/bin/nvcc`, else `nvcc` on the PATH,
    else the toolkit's default install prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in (SOURCES[name], *HEADERS):
        digest.update(path.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every named source (default: all) that has no up-to-date
    library yet, one `nvcc` each, all started together. Returns
    {name: compiler output}; an up-to-date library reports "cached".
    Raises with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    for name in names:
        target = library_path(name)
        if target.exists():
            logs[name] = "cached"
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        procs[name] = (subprocess.Popen(
            [nvcc(), *FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, target)   # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
