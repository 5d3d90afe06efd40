"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled with `nvcc`
into a shared library under `kernels/build/`, at first use, then loaded with
`ctypes`.  The library's file name carries a hash of its source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited source or header is
rebuilt (replacing the old library) and a stale library is never loaded.
Nothing is
compiled when this module is imported: a machine with no `nvcc` imports the
port and runs its plain PyTorch versions on the CPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}
# callables (kind, name, seconds) told of what the port builds at run time:
# ("kernel", source, nvcc seconds) when a library is loaded in this process,
# ("tables", key, seconds) when `flash_attention.pattern_tables` builds
# (`observability/cuda.CompileWatcher`)
LISTENERS: List[Callable[[str, str, float], None]] = []


def notify(kind: str, name: str, seconds: float) -> None:
    for fn in list(LISTENERS):
        fn(kind, name, seconds)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Tuple[Path, float]:
    """Compile `csrc/<name>.cu` unless its library is already built.  Returns
    (library path, seconds spent compiling; 0.0 when it was already there)."""
    out = library_path(name)
    if out.exists():
        return out, 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a private name, then rename: a concurrent build of the same
    # source never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    for stale in BUILD_DIR.glob(f"lib{name}_*.so"):
        if stale != out:
            stale.unlink(missing_ok=True)
    return out, time.perf_counter() - t0


def build_all() -> Dict[str, float]:
    """Build every `csrc/*.cu`, one `nvcc` per source, all started together.
    Returns {name: seconds spent compiling}."""
    names = [p.stem for p in sorted(CSRC.glob("*.cu"))]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: f.result()[1] for name, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path, seconds = build(name)
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
        notify("kernel", name, seconds)
    return lib
