"""Build the port's C extensions with the system compiler and load them.

Two CPython extensions live beside this module:

  * ``fastpack`` — the ingest packer: the object-path grouping pass
    (``pack``), the columnar grouping pass (``group_columns``), ordered
    per-pair sums (``pair_accumulate``), dict payloads to columns
    (``columns_from_payloads``) and the fingerprint's code join
    (``join_codes``);
  * ``internmap`` — the (source, market) pair interner, its sharded probe
    and ordered commit, the delta pair table's per-market match
    (``delta_match_rows``) and the SQLite checkpoint writer, which
    dlopen()s ``libsqlite3`` at first use.

Each compiles at first use with the system ``cc`` (``sysconfig``'s ``CC``,
``-O2 -fPIC -I<Python include> -shared``) into the git-ignored
``.torch_kernels/`` of the package, under a name keyed by a hash of the
source, the flags and the interpreter's ``EXT_SUFFIX``, written under a
temporary name and renamed (so concurrent builders never load a
half-written file). It is loaded as
``bayesian_consensus_engine_tpu_torch._native.<name>``. Nothing is built or
loaded when this module is imported.

The callers fall back to their Python twins (identical outputs) for three
reasons only, each checked before any build: ``BCE_NO_NATIVE`` is set, no
C compiler is found, or ``Python.h`` is missing. :func:`fallback_reason`
says which. A build that fails with both the compiler and the header
present raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shlex
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / ".torch_kernels"
#: Every extension of the port, by module name.
SOURCES = {"fastpack": HERE / "fastpack.c", "internmap": HERE / "internmap.c"}
CFLAGS = ("-O2", "-fPIC")
MODULE_PREFIX = "bayesian_consensus_engine_tpu_torch._native."

_loaded: dict = {}  # module name → module
_lock = threading.Lock()
_record = {"build_seconds": 0.0, "fallback_reason": None}


def native_disabled() -> bool:
    """True when ``BCE_NO_NATIVE`` forces the Python twins.

    Read on every call, so a change of the environment at run time flips
    the packer and the interner together. An explicit ``native=True``
    from a caller still wins over it.
    """
    return os.environ.get("BCE_NO_NATIVE", "").lower() not in (
        "", "0", "false", "off",
    )


def compiler() -> "list[str] | None":
    """The C compiler's argv: ``sysconfig``'s ``CC`` when it is on the
    path, else ``cc``; ``None`` when neither is."""
    for command in (sysconfig.get_config_var("CC") or "", "cc"):
        argv = shlex.split(command)
        if argv and shutil.which(argv[0]):
            return argv
    return None


def python_header() -> "Path | None":
    """``Python.h`` of this interpreter, or ``None`` when it is missing."""
    header = Path(sysconfig.get_path("include")) / "Python.h"
    return header if header.is_file() else None


def fallback_reason(force: bool = False) -> "str | None":
    """Why the Python twins must run instead of the C extensions, or
    ``None`` when the extensions can be built. ``force`` (an explicit
    ``native=True``) ignores ``BCE_NO_NATIVE``. The reason is recorded
    for :func:`report`."""
    if not force and native_disabled():
        reason = "BCE_NO_NATIVE is set"
    elif compiler() is None:
        reason = "no C compiler (sysconfig CC or cc) on the path"
    elif python_header() is None:
        reason = f"Python.h not found under {sysconfig.get_path('include')}"
    else:
        reason = None
    _record["fallback_reason"] = reason
    return reason


def _build_argv() -> list[str]:
    argv = [*compiler(), *CFLAGS, f"-I{sysconfig.get_path('include')}", "-shared"]
    if sys.platform == "darwin":
        # ld64 rejects unresolved CPython symbols without this.
        argv += ["-undefined", "dynamic_lookup"]
    return argv


def library_path(name: str) -> Path:
    """Where the build of extension *name* lives, keyed by its source, the
    compiler and flags, and ``EXT_SUFFIX``."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    digest.update(" ".join(_build_argv()).encode())
    digest.update(suffix.encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}{suffix}"


def build(*names: str) -> list[Path]:
    """Compile every extension in *names* whose build is missing, one
    compiler process each, started together; returns the libraries in
    order. Raises with the compiler's output if a build fails."""
    targets = [library_path(name) for name in names]
    running = []
    start = time.perf_counter()
    for name, target in zip(names, targets):
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=target.suffix, dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [*_build_argv(), str(SOURCES[name]), "-o", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, target, tmp, proc))
    failures = []
    for name, target, tmp, proc in running:
        try:
            output, _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, target)
            else:
                failures.append(f"cc failed on {name}.c:\n{output}")
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if running:
        _record["build_seconds"] += time.perf_counter() - start
    if failures:
        raise RuntimeError("\n".join(failures))
    return targets


def load(name: str, force: bool = False):
    """The extension *name*, built if needed and loaded once per process;
    ``None`` when :func:`fallback_reason` gives a reason. ``force`` (an
    explicit ``native=True``) ignores ``BCE_NO_NATIVE`` and raises
    instead of returning ``None``."""
    module = _loaded.get(name)
    if module is not None and (force or not native_disabled()):
        _record["fallback_reason"] = None
        return module
    reason = fallback_reason(force)
    if reason is not None:
        if force:
            raise RuntimeError(f"the port's C extension {name} is unavailable: "
                               f"{reason}")
        return None
    with _lock:
        module = _loaded.get(name)
        if module is None:
            # Both extensions build together: the first use of either pays
            # for both, once.
            build(*SOURCES)
            fullname = MODULE_PREFIX + name
            path = str(library_path(name))
            loader = importlib.machinery.ExtensionFileLoader(fullname, path)
            spec = importlib.util.spec_from_file_location(
                fullname, path, loader=loader)
            module = importlib.util.module_from_spec(spec)
            loader.exec_module(module)
            sys.modules[fullname] = module
            _loaded[name] = module
        return module


def report() -> dict:
    """What this process found and did: whether both extensions are
    loaded, the seconds it spent compiling, the compiler, ``Python.h``,
    and the last fallback reason recorded (``None`` when none was)."""
    cc = compiler()
    header = python_header()
    return {
        "built": all(name in _loaded for name in SOURCES),
        "build_seconds": _record["build_seconds"],
        "compiler": " ".join(cc) if cc else None,
        "python_h": str(header) if header else None,
        "fallback_reason": _record["fallback_reason"],
    }
