"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/<hash>/<name>.so <name>.cu

``build/torch_kernels`` lies in the source tree; an installed copy builds
under ``$XDG_CACHE_HOME/imageanalysis3_tpu_torch`` (default ``~/.cache``)
instead.  The directory is keyed by a hash of every source and the flags, so
an edit rebuilds.  The libraries are loaded with ctypes; the wrappers in ``ops/``
pass tensor pointers and the current stream as ``c_void_p``.  Nothing here
runs at import time, and a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("seed_pyramid", "lm_fit", "seed_classify", "dual_blur",
           "level_stencil", "gather_cubes")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each kernel built by
#: this process, for logging
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")   # the toolkit's default prefix
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "imageanalysis3_tpu_torch are built from csrc/*.cu")


def _build_root() -> Path:
    """``build/torch_kernels`` of the source tree the package sits in, or,
    for an installed copy, a per-user cache directory."""
    tree = CSRC.parent.parent
    if (tree / "pyproject.toml").exists():
        return tree / "build" / "torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "imageanalysis3_tpu_torch"


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _build_root() / h.hexdigest()[:16]


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out_dir / f"{n}.so").exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out_dir / f"{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out_dir / f"{name}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_build_dir() / f"{name}.so"))
        _loaded[name] = lib
    return lib


def native_library_path(name: str, src: str, flags: Iterable[str]) -> Path:
    """Where the host library `name`, built with g++ from `src` with
    `flags`, lives: ``<name>/<hash>/<name>.so`` under the build root, in a
    0700 directory keyed by a hash of the source and the flags."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(Path(src).read_bytes())
    d = _build_root() / name / h.hexdigest()[:16]
    os.makedirs(d, mode=0o700, exist_ok=True)
    return d / f"{name}.so"


def load_native_library(name: str, src: str,
                        flags: Iterable[str]) -> ctypes.CDLL:
    """Build the host library `name` once (g++ into a private temporary
    file, made 0700, then renamed into place) and load it.  A library not
    owned by this user, or writable by anyone else, is refused: it would be
    loaded with this process's privileges.  Raises ``OSError`` (no
    source, no compiler, a foreign library or a failed load) or
    ``CalledProcessError`` (a failed build)."""
    flags = tuple(flags)
    path = native_library_path(name, src, flags)
    if not path.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        try:
            subprocess.run(["g++", *flags, "-o", tmp, str(src)], check=True,
                           capture_output=True)
            os.chmod(tmp, 0o700)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    st = os.stat(path)
    if st.st_uid != os.getuid() or (st.st_mode & 0o022):
        raise PermissionError(f"{path} is not exclusively user-owned; "
                              "refusing to load it")
    return ctypes.CDLL(str(path))
