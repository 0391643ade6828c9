"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``repro_torch/kernels/<family>/csrc/<name>.cu`` compiles, at first
use, into its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

under the repository's ``build/`` directory (listed in ``.gitignore``),
keyed by a hash of the family's sources and the flags, so an edited source
rebuilds and an unchanged one loads as is.  ``build()`` starts one ``nvcc``
per source, all at once.  A failed build raises with the compiler's
output; ``-Xptxas -v`` (registers, shared memory, spills) is kept beside
the library in ``<name>-<hash>.log``.

Pointers and the stream go into the C functions as ``c_void_p``; each
returns ``cudaGetLastError()`` after its launch and the wrapper raises on
anything but 0.  This never runs at import: the CPU tests import every
module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Every kernel source in the package, by name (the file's stem)."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the toolkit is")


def target(name: str) -> Path:
    """The library a source builds into: keyed by the contents of its
    ``csrc`` directory and the flags."""
    src = sources()[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(src.parent.glob("*.cu*")):
        h.update(dep.name.encode() + dep.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` per source started together.  Returns {name: library}."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    out, procs = {}, []
    for name in names:
        lib = target(name)
        out[name] = lib
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        log = proc.communicate()[0]
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {srcs[name]} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]
