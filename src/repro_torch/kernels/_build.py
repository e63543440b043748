"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface.  It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at
the repository root (listed in ``.gitignore``), under a file name keyed by
a hash of the source, of every ``csrc/*.cuh`` header it includes (directly
or through another header) and of the flags, so an edited source or header
rebuilds and an unchanged one loads the library already built.  Nothing is
compiled when a module is imported: the CPU tests import every module on a
machine without ``nvcc``.

``build(names)`` starts one ``nvcc`` per missing library, all at once, and
waits for them together.  A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# every kernel source of the port, in csrc/<name>.cu
KERNELS = ("agg_weighted_sum", "topk_compress", "flash_attention",
           "flash_attention_bwd", "ssm_scan", "ssm_scan_bwd", "rmsnorm")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built with it at first use")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"/]+\.cuh)"', re.M)


def sources(name: str) -> List[str]:
    """``<name>.cu`` and the ``csrc`` headers it includes, transitively, in
    the order first reached."""
    files, todo = [], [f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f in files:
            continue
        files.append(f)
        todo += [inc.decode() for inc in
                 _INCLUDE.findall((CSRC / f).read_bytes())
                 if (CSRC / inc.decode()).is_file()]
    return files


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sources(name):
        h.update(f.encode() + b"\0" + (CSRC / f).read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, in parallel.
    Returns name -> library path.  The compiler's output (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside each library as
    ``<library>.log``."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for n in todo:
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        Path(str(paths[n]) + ".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n} (exit {proc.returncode}):\n"
                          f"{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return lib
