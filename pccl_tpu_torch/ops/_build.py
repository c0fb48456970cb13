"""Build the port's native code at first use.

- `build_kernels()`: every `pccl_tpu_torch/csrc/*.cu` becomes its own shared
  library with a plain C interface (`nvcc -gencode arch=compute_90a,code=
  sm_90a -O3 -shared -Xcompiler -fPIC`), loaded with ctypes. One nvcc per
  source, all started together. No PyTorch headers are compiled, so a
  build takes seconds, not minutes.
- `build_pcclt()`: the C++ core `libpcclt.so` from `pccl_tpu/native/src`,
  the library only (no test binaries), one g++ per source in parallel;
  `ensure_pcclt()` does the same under an exclusive lock, so that
  concurrent processes (test workers) build it once between them.

Both write into `pccl_tpu_torch/build/` and skip sources whose output is
newer than every input (`force=True` rebuilds all). Outputs land under a
temporary name and are renamed into place, so concurrent first users never
load a half-written file.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NATIVE = PKG_DIR.parent / "pccl_tpu" / "native"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# the library's sources and per-file flags, as pccl_tpu/native/tools/
# build_gcc.sh lists them
PCCLT_SOURCES = ["log", "telemetry", "guarded_alloc", "wire", "shm", "sockets",
                 "uring", "netem", "protocol", "journal", "hash", "hash_clmul",
                 "ss_chunk", "kernels", "kernels_avx2", "quantize", "bandwidth",
                 "atsp", "schedule", "benchmark", "master_state", "master",
                 "client", "reduce", "api"]
PCCLT_ARCH = {"kernels_avx2": ["-mavx2"],
              "hash_clmul": ["-mpclmul", "-msse4.1"]}
GXX_FLAGS = ["-std=c++20", "-O2", "-fPIC", "-pthread", "-fopenmp-simd",
             "-Iinclude"]

_KERNEL_LIBS: dict = {}


class BuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the CUDA kernels build only where the CUDA toolkit is")


def _stale(out: Path, inputs) -> bool:
    if not out.exists():
        return True
    t = out.stat().st_mtime
    return any(p.stat().st_mtime > t for p in inputs)


def _run_all(jobs, what: str) -> list:
    """Start every (cmd, tmp, out) job at once; wait for all; rename each
    finished output into place. Returns the jobs' combined output."""
    procs = [(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True, cwd=cwd),
              tmp, out) for cmd, cwd, tmp, out in jobs]
    logs, failed = [], []
    for p, tmp, out in procs:
        text, _ = p.communicate()
        logs.append(text)
        if p.returncode != 0:
            failed.append(f"{out.name}:\n{text}")
        elif tmp is not None:
            os.replace(tmp, out)
    if failed:
        raise BuildError(f"{what} failed:\n" + "\n".join(failed))
    return logs


def build_kernels(ptxas_verbose: bool = False) -> str:
    """Compile every stale csrc/*.cu into build/lib<name>.so. Returns the
    compilers' output (with ptxas_verbose: registers, shared memory and
    spills of each kernel; that forces a rebuild)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    headers = sorted(CSRC.glob("*.cuh"))
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        out = BUILD_DIR / f"lib{src.stem}.so"
        if not ptxas_verbose and not _stale(out, [src, *headers]):
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        if ptxas_verbose:
            cmd += ["-Xptxas", "-v"]
        jobs.append((cmd, None, tmp, out))
    return "\n".join(_run_all(jobs, "nvcc"))


def kernel_lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if stale."""
    lib = _KERNEL_LIBS.get(name)
    if lib is None:
        build_kernels()
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        _KERNEL_LIBS[name] = lib
    return lib


def build_pcclt(force: bool = False) -> Path:
    """Build libpcclt.so from pccl_tpu/native/src into build/; returns its
    path. force: rebuild every object and the library, whatever their
    times (a library that came with a copied tree was built elsewhere)."""
    if not (NATIVE / "src").is_dir():
        raise BuildError(f"native sources not found under {NATIVE}")
    obj_dir = BUILD_DIR / "pcclt_obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / "libpcclt.so"
    srcs = [NATIVE / "src" / f"{n}.cpp" for n in PCCLT_SOURCES
            if (NATIVE / "src" / f"{n}.cpp").exists()]
    headers = [*(NATIVE / "src").glob("*.hpp"), *(NATIVE / "include").glob("*.h")]
    objs, jobs = [], []
    for src in srcs:
        obj = obj_dir / f"{src.stem}.o"
        objs.append(obj)
        if force or _stale(obj, [src, *headers]):
            tmp = obj.with_name(f"{obj.name}.{os.getpid()}.tmp")
            jobs.append((["g++", *GXX_FLAGS, *PCCLT_ARCH.get(src.stem, []),
                          "-c", str(src), "-o", str(tmp)], NATIVE, tmp, obj))
    _run_all(jobs, "g++ (libpcclt objects)")
    if force or _stale(out, objs):
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        _run_all([(["g++", "-shared", *GXX_FLAGS, "-o", str(tmp),
                    *map(str, objs)], NATIVE, tmp, out)], "g++ (link libpcclt)")
    return out


def ensure_pcclt() -> Path:
    """build_pcclt() under an exclusive flock on build/libpcclt.lock:
    the first caller builds (about two minutes of CPU), the others wait for
    it and then find the library fresh. Returns the library's path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libpcclt.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return build_pcclt()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
