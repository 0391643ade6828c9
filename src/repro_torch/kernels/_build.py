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
anything but 0.  ``ptxas_report`` reads that log per kernel, and
``sass_counts`` counts instructions in a built library's SASS
(``cuobjdump -sass``), which shows what ran on the tensor cores (``HMMA``)
and what loaded asynchronously (``LDGSTS``).  This never runs at import:
the CPU tests import every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

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


def _tool(name: str) -> Optional[str]:
    """A CUDA toolkit binary beside ``nvcc``, or on ``PATH``; None if
    there is none."""
    try:
        beside = Path(nvcc()).parent / name
    except RuntimeError:
        beside = None
    if beside is not None and beside.is_file():
        return str(beside)
    return shutil.which(name)


def demangle(names: List[str]) -> Dict[str, str]:
    """{mangled: readable} through ``cu++filt`` (or ``c++filt``); a name
    stays as it is where neither is installed."""
    tool = _tool("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else \
        {n: n for n in names}


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name) of an ``-Xptxas -v`` log: registers,
    spill stores and loads (bytes), stack frame and static shared memory
    (bytes)."""
    rep: Dict[str, Dict[str, int]] = {}
    fn = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
            rep[fn] = dict(registers=0, spill_stores=0, spill_loads=0,
                           stack=0, smem=0)
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            rep[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            rep[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            rep[fn]["smem"] = int(m.group(1)) if m else 0
    return rep


def parse_sass(sass: str, ops=("HMMA", "LDGSTS")) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name) of ``cuobjdump -sass`` output: how many
    instructions of each opcode in ``ops`` it holds."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    pat = re.compile(r"\b(" + "|".join(ops) + r")\b")
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            out[fn] = {op: 0 for op in ops}
        elif fn is not None and "/*" in ln:
            for op in pat.findall(ln.split("*/", 1)[-1]):
                out[fn][op] += 1
    return out


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """:func:`parse_ptxas` of the build log of source ``name``."""
    return parse_ptxas(target(name).with_suffix(".log").read_text())


def sass_counts(name: str,
                ops=("HMMA", "LDGSTS")) -> Dict[str, Dict[str, int]]:
    """:func:`parse_sass` of the built library ``name``.  Raises where
    ``cuobjdump`` is missing."""
    tool = _tool("cuobjdump")
    if tool is None:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    sass = subprocess.run([tool, "-sass", str(build([name])[name])],
                          capture_output=True, text=True, check=True).stdout
    return parse_sass(sass, ops)
