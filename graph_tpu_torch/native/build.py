"""On-demand g++ build of the port's host C++ (``graph_tpu_torch/native``).

Counterpart of ``graph_tpu.native.build``.  Each ``<name>.cpp`` beside
this module has a plain C interface and is compiled by ``g++ -O3
-march=native`` into its own shared library, loaded with ``ctypes``.
Libraries go into ``graph_tpu_torch/build/`` (listed in ``.gitignore``)
under a name that carries the hash of the source, the flags and the CPU
that ``-march=native`` compiles for, so an edited source is rebuilt at
its next use and a library is never loaded on a CPU it was not built
for.  Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")
_LOCK = threading.Lock()


def _cpu_identity() -> bytes:
    """The CPU's model and feature flags: what ``-march=native`` targets."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = {line for line in f
                     if line.startswith((b"model name", b"flags"))}
    except OSError:
        lines = set()
    return platform.machine().encode() + b"".join(sorted(lines))


def library_path(source_name: str) -> Path:
    """Where the library built from ``native/<source_name>`` lives."""
    h = hashlib.blake2b(digest_size=8)
    h.update((NATIVE_DIR / source_name).read_bytes())
    h.update("\0".join(GXX_FLAGS).encode())
    h.update(_cpu_identity())
    base = source_name.rsplit(".", 1)[0]
    return BUILD_DIR / f"{base}-{h.hexdigest()}.so"


def build_library(source_name: str) -> str:
    """Compile ``native/<source_name>`` unless its library exists; returns
    the library's path.

    Raises ``CalledProcessError`` (with g++'s output) when the compiler
    fails, and ``FileNotFoundError`` when there is no g++."""
    out = library_path(source_name)
    if out.exists():
        return str(out)
    with _LOCK:
        if out.exists():
            return str(out)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        subprocess.run(["g++", *GXX_FLAGS, str(NATIVE_DIR / source_name),
                        "-o", str(tmp)], check=True, capture_output=True)
        os.replace(tmp, out)
    return str(out)


def try_load(source_name: str) -> Tuple[Optional[ctypes.CDLL],
                                        Optional[str]]:
    """``(library, None)``, or ``(None, why)`` when ``native/<source_name>``
    cannot be built (no g++, a compiler error) or loaded."""
    try:
        return ctypes.CDLL(build_library(source_name)), None
    except subprocess.CalledProcessError as exc:
        return None, f"g++ failed: {exc.stderr.decode(errors='replace')}"
    except OSError as exc:
        return None, str(exc)
