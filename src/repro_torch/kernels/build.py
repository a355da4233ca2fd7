"""Build and load the port's CUDA kernels: nvcc into shared libraries with a
plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own for ``sm_90a`` into
``build/repro_torch_kernels/<name>-<hash>.so`` at the repository root, with
nvcc's output (ptxas' register and spill report) beside it in
``<name>-<hash>.log``.  The hash covers the source and the flags, so a
library is rebuilt only when either changes.  Builds happen at first use
(``load``), or all at once and in parallel through ``build_all``; nothing is
compiled at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def any_dtensor(*tensors) -> bool:
    """Whether any argument is a DTensor: the kernels read raw pointers of
    plain tensors, which a DTensor's global view does not give."""
    import torch.distributed as dist

    if not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in tensors)


def misaligned(tensors, n: int = 16) -> bool:
    """Whether a tensor's data does not start on an ``n``-byte boundary.  A
    fake tensor (the dry run's) has no data and passes."""
    from torch._subclasses.fake_tensor import is_fake

    return any(not is_fake(t) and t.data_ptr() % n for t in tensors)


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile every stale library, one nvcc process per source, all started
    together.  Returns the wall seconds each build took (0.0 = up to date)."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: dict[str, tuple[subprocess.Popen, Path, Path, float]] = {}
    secs = {n: 0.0 for n in names}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)  # before the library appears
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def build_log(name: str) -> str:
    """nvcc's output from the build of the current library of ``name``."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
