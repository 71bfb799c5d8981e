"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` is compiled on its own, for Hopper (`sm_90a`), into a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so \
         src/repro_torch/csrc/<name>.cu

`<hash>` covers the source, every `csrc/` header it includes (`#include
"<header>.cuh"`, followed transitively) and the flags, so an edited source
or header is rebuilt at its next use. `build()` starts one nvcc per
missing library, all at once, and raises with nvcc's output when any of
them fails; its output (the `-Xptxas -v` register and shared-memory lines
among it) is kept in `BUILD_LOGS`. Nothing is built or loaded when this module is imported.

Every C entry point returns `cudaGetLastError()` after its launch, and
`check` raises when that is not 0: a refused launch never runs, and a
later `torch.cuda.synchronize()` would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: `build/kernels` at the root of the checkout (git-ignored).
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("bsr_predict", "topk", "hinge", "hvp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: nvcc's output of the builds this process ran, by kernel name.
BUILD_LOGS: dict[str, str] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{CSRC} on a machine with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """`csrc/<name>.cu` and the `csrc/` headers it includes, transitively,
    in a fixed order."""
    seen: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep.exists():
                todo.append(dep)
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, Path]:
    """Compile every named kernel whose library is missing, all nvcc
    processes at once; returns the library path of each name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, target)
    failed = []
    for name, (proc, tmp, target) in running.items():
        out, _ = proc.communicate()
        BUILD_LOGS[name] = out
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}):\n"
                          f"{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of kernel library `name`, built and
    loaded at first use, returning an int (a `cudaError_t`)."""
    key = (name, symbol)
    fn = _FUNCS.get(key)
    if fn is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        fn = getattr(lib, symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        fn.error_string = lib.kernel_error_string
        _FUNCS[key] = fn
    return fn


def check(fn, code: int) -> None:
    """Raise when a launch returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{fn.__name__} failed: "
                           f"{fn.error_string(code).decode()} "
                           f"(cudaError {code})")
