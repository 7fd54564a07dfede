"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under radiativetransfer_tpu_torch/csrc/ is compiled by hand
with nvcc into its own shared library with a plain C interface, in
`radiativetransfer_tpu_torch/_build/`, named by a hash of the source and
the flags, so an edited source rebuilds.  `build()` starts one nvcc for
every source not built yet, all at once, and waits for them together.
Nothing is compiled or loaded at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {
    "sweep_merged": _PKG / "csrc" / "sweep_merged.cu",
    "probes": _PKG / "csrc" / "probes.cu",
    "sweep_variants": _PKG / "csrc" / "sweep_variants.cu",
    "scatter_rows": _PKG / "csrc" / "scatter_rows.cu",
    "sweep_rdma": _PKG / "csrc" / "sweep_rdma.cu",
    "sweep_cluster": _PKG / "csrc" / "sweep_cluster.cu",
}
BUILD_DIR = _PKG / "_build"
# IEEE expf and division (never --use_fast_math), and -fmad=false so each
# operation rounds as the plain PyTorch versions round it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# per source: nvcc's command, output and time of the last build in this
# process (absent when the library was already built)
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    candidates = [os.environ.get("NVCC"), shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home is None:
        from torch.utils import cpp_extension
        cuda_home = cpp_extension.CUDA_HOME
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME): the CUDA "
                       "kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Shared library of one source, named by a hash of source and flags."""
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def sass(name: str) -> str:
    """The SASS listing of one built source, by the cuobjdump beside nvcc."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True).stdout


def build(*names: str) -> dict[str, ctypes.CDLL]:
    """Compile (where not built yet) and load the named sources, all of
    them when none is named; idempotent within a process.  Returns the
    loaded libraries by name."""
    names = names or tuple(SOURCES)
    todo = [n for n in names if n not in _LIBS
            and not library_path(n).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            path = library_path(name)
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            procs[name] = (cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        failed = []
        for name, (cmd, tmp, proc) in procs.items():
            out, err = proc.communicate()
            BUILD_LOG[name] = (f"{' '.join(cmd)}\n{out}{err}built in "
                               f"{time.perf_counter() - t0:.2f} s\n")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{BUILD_LOG[name]}")
            else:
                os.replace(tmp, library_path(name))
        if failed:
            raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return {name: _LIBS[name] for name in names}
