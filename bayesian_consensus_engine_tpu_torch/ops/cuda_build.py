"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` compiles on its own into a shared library with
a plain C interface, at first use, under the git-ignored ``.torch_kernels/``
of the package, named by a hash of the source, the ``.cuh`` headers beside
it and the flags (an edited source or header builds anew; an unchanged one
is reused). The flags target Hopper
(``sm_90a``) at ``-O3`` without ``--use_fast_math``, which would change
``exp2f`` and division and flush denormals. Nothing is built or loaded
when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[1] / ".torch_kernels"
CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: Every kernel source of the port, one library each.
SOURCES = tuple(
    CSRC / name for name in (
        "settle_cycles.cu", "onepass_settle.cu", "bp_sweep.cu",
        "onepass_partials.cu",
    )
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[Path, ctypes.CDLL] = {}  # by source path
_lock = threading.Lock()


def _nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")


def library_path(source: Path) -> Path:
    """Where the build of *source* lives, keyed by its content, the
    headers beside it and the flags."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(*sources: Path) -> list[tuple[Path, str]]:
    """Compile every source whose build is missing, all at once (one
    ``nvcc`` per source, started together); returns ``(library, log)``
    per source, in order.

    The log is nvcc's output (``-Xptxas -v``: registers, stack frames,
    spills), kept beside the library, so a build that was reused returns
    the log it was made with; a library without its log is built again. Each library is written under a temporary
    name and renamed, so a concurrent build never loads a half-written
    file. Raises with nvcc's output if any build fails.
    """
    targets = [library_path(source) for source in sources]
    running = []
    for source, target in zip(sources, targets):
        if target.exists() and _log_path(target).exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((source, target, tmp, proc))
    failures = []
    for source, target, tmp, proc in running:
        try:
            output, _ = proc.communicate()
            if proc.returncode == 0:
                _log_path(target).write_text(output)
                os.replace(tmp, target)
            else:
                failures.append(f"nvcc failed on {source.name}:\n{output}")
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failures:
        raise RuntimeError("\n".join(failures))
    return [(target, _log_path(target).read_text()) for target in targets]


def _log_path(library: Path) -> Path:
    return library.with_suffix(".log")


def build_all() -> list[tuple[Path, str]]:
    """:func:`build` of every kernel source (:data:`SOURCES`), in parallel."""
    return build(*SOURCES)


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Per entry function of a build's log (``-Xptxas -v``), keyed by its
    mangled name: ``registers``, ``stack_bytes``, ``spill_stores`` and
    ``spill_loads`` as ptxas printed them."""
    report: dict[str, dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        found = re.search(r"Function properties for (\S+)", line) or re.search(
            r"Compiling entry function '([^']+)'", line)
        if found:
            current = report.setdefault(found.group(1), {})
            continue
        if current is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if frame:
            current.update(stack_bytes=int(frame.group(1)),
                           spill_stores=int(frame.group(2)),
                           spill_loads=int(frame.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            current["registers"] = int(used.group(1))
    return report


def load(source: Path, signatures: dict) -> ctypes.CDLL:
    """The library of *source*, built if needed and loaded once per
    process, with ``argtypes`` set from *signatures* (function name →
    list of ctypes types) and every function returning a C ``int``.

    Later calls return the loaded library without touching the file
    system: a launch must not pay for hashing the source.
    """
    lib = _loaded.get(source)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            target, _log = build(source)[0]
            lib = ctypes.CDLL(str(target))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[source] = lib
        return lib


def check_tensor(name, tensor, dtype, shape, device) -> None:
    """A kernel wrapper's check of one argument before its pointer goes to
    C: a contiguous tensor of *dtype* and *shape* on *device*, or raise."""
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if tensor.device != device:
        raise ValueError(f"{name} is on {tensor.device}, expected {device}")
    if tensor.dtype != dtype:
        raise TypeError(f"{name} has dtype {tensor.dtype}, expected {dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(tensor.shape)}, expected {tuple(shape)}"
        )
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
