"""Build and load the hand-written CUDA kernels of ``graph_tpu_torch/csrc``.

Each ``<source>.cu`` has a plain C interface, one ``extern "C"`` entry
point per kernel, and is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library, loaded with ``ctypes``.  Libraries go into
``graph_tpu_torch/build/`` (listed in ``.gitignore``) under a name that
carries the hash of the source and the flags, so an edited source is
rebuilt at its next use and an unchanged one is not.  Nothing is built
when the module is imported: a wrapper builds its kernel's source at its
first launch, and :func:`build` builds several sources at once, one
``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
#: The C entry point of each kernel: (pointers..., counts, [options],
#: stream) -> cudaError; the device loop's graph assembly (``loop_*``)
#: takes and returns opaque handles.
SIGNATURES = {
    "k1_gather": (_P, _P, _P, _I64, _I32, _P),
    "k1_gather_weighted": (_P, _P, _P, _P, _I64, _I32, _I32, _I32, _P),
    "k2_reduce": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    "k2_reduce_min": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I32, _P),
    "jacobi_quantize": (_P, _P, _P, _I64, _I32, _P),
    "jacobi_update": (_P, _P, _P, _I64, _F32, _F32, _P, _P, _I32, _P),
    "tc_count": (_P, _P, _P, _I64, _P, _I64, _I64, _I64, _P, _P),
    "probe_row_gather": (_P, _P, _P, _I64, _I32, _P),
    "probe_lanemap": (_P, _P, _P, _I64, _I32, _P),
    "probe_window_gather": (_P, _P, _P, _I64, _I32, _I32, _P),
    "probe_sublane": (_P, _P, _P, _I64, _I32, _P),
    "probe_sec_stream": (_P,) * 10 + (_I64,) + (_I32,) * 7 + (_P,),
    "probe_sec_stream_f32": (_P,) * 10 + (_I64,) + (_I32,) * 5 + (_P,),
    "probe_sec_route": (_P,) * 15 + (_I64,) + (_I32,) * 4 + (_P,),
    "probe_sec128": (_P,) * 15 + (_I64,) + (_I32,) * 4 + (_P,),
    "probe_sec_clusters": (_I32,),
    "loop_seq_new": (_PP,),
    "loop_seq_child": (_P, _P),
    "loop_seq_while": (_P, _I32, _P, _P, _P, _P, _PP),
    "loop_seq_if": (_P, _P, _P, _PP),
    "loop_seq_close": (_P,),
    "loop_seq_instantiate": (_P, _PP),
    "loop_exec_launch": (_P, _P),
    "loop_seq_free": (_P,),
    "loop_exec_free": (_P,),
    "loop_graph_kernels": (_P, ctypes.c_char_p, _I64,
                           ctypes.POINTER(ctypes.c_longlong)),
}
#: The source (``csrc/<source>.cu``) that defines each entry point.
SOURCES = {
    "k1_gather": "k1_gather",
    "k1_gather_weighted": "k1_gather",
    "k2_reduce": "k2_reduce",
    "k2_reduce_min": "k2_reduce",
    "jacobi_quantize": "jacobi_tails",
    "jacobi_update": "jacobi_tails",
    "tc_count": "tc_count",
    "probe_row_gather": "k1_probes",
    "probe_lanemap": "k1_probes",
    "probe_window_gather": "k1_probes",
    "probe_sublane": "k1_probes",
    "probe_sec_stream": "k2_probes",
    "probe_sec_stream_f32": "k2_probes",
    "probe_sec_route": "k2_sections",
    "probe_sec128": "k2_sections",
    "probe_sec_clusters": "k2_sections",
    **{name: "device_loop" for name in (
        "loop_seq_new", "loop_seq_child", "loop_seq_while", "loop_seq_if",
        "loop_seq_close", "loop_seq_instantiate", "loop_exec_launch",
        "loop_seq_free", "loop_exec_free", "loop_graph_kernels")},
}

_libs: dict = {}
_fns: dict = {}
#: nvcc's output for each source compiled by this process.
LOGS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>.cu`` lives."""
    h = hashlib.blake2b(digest_size=8)
    h.update((CSRC / f"{source}.cu").read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source}-{h.hexdigest()}.so"


def build(names=tuple(SIGNATURES)) -> list:
    """Compile the sources of the named kernels that have no current
    library, in parallel.

    Returns the sources that were compiled; raises with nvcc's output
    when one fails."""
    sources = sorted({SOURCES[n] for n in names})
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return []
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for source in todo:
        out = library_path(source)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{source}.cu")]
        procs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for source, out, tmp, proc in procs:
        log, _ = proc.communicate()
        LOGS[source] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{source}: nvcc exit {proc.returncode}\n{log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return todo


def ptxas_usage(log: str) -> list:
    """Each kernel's registers, stack frame and spills, as ``-Xptxas -v``
    reported them in a build's ``log``: a list of dicts (``function``,
    ``registers``, ``stack``, ``spill_stores``, ``spill_loads``)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            cur = None
    return out


def load(name: str):
    """The C entry point of kernel ``name``, its source built first if
    needed."""
    fn = _fns.get(name)
    if fn is None:
        source = SOURCES[name]
        lib = _libs.get(source)
        if lib is None:
            build((name,))
            lib = _libs[source] = ctypes.CDLL(str(library_path(source)))
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn
