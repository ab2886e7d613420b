"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``; tensors
are passed as ``data_ptr()`` integers and the stream as
``torch.cuda.current_stream().cuda_stream``. Every C entry returns the
``cudaGetLastError()`` of its launch, and ``agw_error_string`` names it.

The build happens at first use, from the sources in this package only,
into ``ai_safety_gridworlds_torch/_build/<digest>/`` (listed in
``.gitignore``), where the digest covers every file of ``csrc/`` and the
compiler flags. All sources compile at once, one ``nvcc`` each. A failed
build raises; nothing falls back to the plain versions. A build holds the
module's lock, so a build started on another thread (``chip_smoke.py``
builds while it runs phases that launch no kernel) makes a ``load`` wait
for it instead of compiling the same source twice.

``--fmad=false`` is part of the contract: without it ``nvcc`` contracts the
stencil's last product and ``1 - prod`` into one FMA, and the kernel's fire
draws would no longer be bit-equal to the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[1] / "_build"
KERNELS = ("prf_words", "fused_firemaker", "fused_scalar", "fused_island_ma",
           "fused_savanna")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict = {}
_lock = threading.RLock()


def nvcc_path() -> str:
    """The CUDA compiler: on ``PATH``, under ``$CUDA_HOME``, or in the
    toolkit's default install location."""
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found; the CUDA kernels cannot be built")


def build_dir() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def build(names=KERNELS) -> dict:
    """Compile the named kernels that are not built yet, all at once.

    Returns ``{name: compiler log}`` (``-Xptxas -v`` register and shared
    memory report) for every name; raises ``RuntimeError`` with the
    compiler's output when a build fails."""
    with _lock:
        return _build(names)


def _build(names) -> dict:
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        if (out_dir / f"lib{name}.so").exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode:
            failed.append(f"--- nvcc {name} (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    logs = {}
    for name in names:
        log = out_dir / f"{name}.log"
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_dir() / f"lib{name}.so"
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            lib.agw_error_string.argtypes = [ctypes.c_int]
            lib.agw_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if err:
        msg = lib.agw_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
