"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` compiles to an object for ``sm_90a`` (one ``nvcc``
per source, all started together), and the objects link into one
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu
    nvcc -shared -o build/kernels/libreprotorch-<hash>.so *.o

The library's name carries a hash of the sources, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds on first use and an unchanged one is loaded as
built.  Nothing is built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
#: build outputs live in the checkout's ``build/`` (listed in .gitignore)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_functions: dict[str, object] = {}
#: what the last `build` did: library path, seconds, ptxas report
build_info: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[pathlib.Path]:
    """The shared headers the sources include (part of the hash)."""
    return sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for flag in ARCH_FLAGS + COMPILE_FLAGS:
        h.update(flag.encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libreprotorch-{source_hash()}.so"


def build() -> pathlib.Path:
    """Compile and link the library unless a fresh build exists."""
    out = library_path()
    if out.exists():
        if build_info.get("path") != str(out):   # keep this process's build
            build_info.update(path=str(out), seconds=0.0, built=False,
                              log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            cmd = [cc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        tmp_lib = pathlib.Path(tmp) / out.name
        link = subprocess.run(
            [cc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)     # atomic: concurrent builders agree
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      built=True, log="\n".join(log))
    return out


def function(name: str, argtypes) -> object:
    """The C entry point ``name`` of the built library, typed."""
    global _lib
    with _lock:
        fn = _functions.get(name)
        if fn is None:
            if _lib is None:
                _lib = ctypes.CDLL(str(build()))
            fn = getattr(_lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[name] = fn
        return fn
