"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``*.cu`` source here compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The build
runs at first use into ``csrc/build/`` (ignored by git), one ``nvcc`` per
source, all started together. A library's file name carries a hash of its
source, the shared headers (``*.cuh``) and the flags, so an edited source or
header rebuilds and a stale library is never loaded. The tensor-core GEMMs
fetch ``cuTensorMapEncodeTiled`` from the driver through the runtime
(``cudaGetDriverEntryPointByVersion``), so no ``-lcuda`` is needed.

    python -m brevitas_tpu_torch.csrc.build     # build every kernel
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE / "build"
SOURCES = {
    "int8_matmul": HERE / "int8_matmul.cu",
    "int4_weight_only_matmul": HERE / "int4_weight_only_matmul.cu",
    "int4_matmul": HERE / "int4_matmul.cu",
    "int8_attention": HERE / "int8_attention.cu",
    "int4kv_decode_attention": HERE / "int4kv_decode_attention.cu",
    "quant_lstm_cell": HERE / "quant_lstm_cell.cu",
    "fake_quant": HERE / "fake_quant.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(HERE.glob("*.cuh")))
    digest = hashlib.sha256(SOURCES[name].read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that have no up-to-date
    library yet, in parallel. Returns each compiled kernel's ptxas report
    (registers, shared memory, spills); raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


if __name__ == "__main__":
    t0 = time.perf_counter()
    for kernel, report in build(sys.argv[1:] or None).items():
        print(f"== {kernel}\n{report}")
    print(f"built in {time.perf_counter() - t0:.1f} s")
