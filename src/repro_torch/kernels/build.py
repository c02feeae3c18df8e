"""Builds the hand-written CUDA kernels and loads them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, all sources at once in parallel
processes.  The libraries go to ``build/repro_torch/<hash>/`` at the root
of the checkout, keyed by a hash of the sources and the flags, so an edit
rebuilds and an unchanged tree reuses the last build.  A missing ``nvcc``
or a failed compile raises with the compiler's output.

No ``--use_fast_math``: the quantizers divide and must round exactly.
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

from repro_torch.analysis import events as _events

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library; filled on first use in this process
_LIBS: "dict[str, ctypes.CDLL]" = {}
# (library, symbol) -> C function with its signature set
_FUNCS: "dict[tuple[str, str], ctypes._CFuncPtr]" = {}
# what the last build in this process did: seconds, directory, ptxas notes
LAST_BUILD: "dict[str, object]" = {}


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, else the one
    on ``PATH``, else the toolkit PyTorch was built to find."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    from torch.utils import cpp_extension
    if cpp_extension.CUDA_HOME:
        cands.append(Path(cpp_extension.CUDA_HOME) / "bin" / "nvcc")
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of repro_torch cannot be built")


def sources() -> "list[Path]":
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source (in parallel) unless this tree's build exists;
    returns the directory holding ``lib<name>.so`` for each source."""
    out_dir = BUILD_ROOT / _digest()
    srcs = sources()
    if all((out_dir / f"lib{s.stem}.so").is_file() for s in srcs):
        return out_dir
    nvcc = nvcc_path()
    _events.emit("kernel_build", dir=out_dir.name)
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    t0 = time.perf_counter()
    procs = []
    for s in srcs:
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp / f"lib{s.stem}.so"), str(s)]
        procs.append((s, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True)))
    failures, notes = [], {}
    for s, p in procs:
        out, _ = p.communicate()
        notes[s.name] = out
        if p.returncode != 0:
            failures.append(f"--- nvcc {s.name} (exit {p.returncode}) ---\n{out}")
    if failures:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    try:
        tmp.rename(out_dir)
    except OSError:
        # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    LAST_BUILD.update(seconds=time.perf_counter() - t0, dir=str(out_dir),
                      ptxas=notes)
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building all sources on
    first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _events.emit("kernel_load", name=name)
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> "ctypes._CFuncPtr":
    """``symbol`` of the library built from ``csrc/<name>.cu``, with its
    argument types set on first use and an ``int`` (CUDA error code)
    return."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (``cudaGetLastError``)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")


#: what each library's ``kernel_resources`` query reports, in its order
#: (``csrc/resources.cuh``)
RESOURCE_FIELDS = ("registers", "max_dynamic_smem", "smem", "threads",
                   "static_smem", "ctas_per_sm", "cluster_ctas",
                   "max_active_clusters")


def resources(name: str, a: int = 0, b: int = 0, c: int = 0) -> dict:
    """What the card holds for one built variant of ``csrc/<name>.cu``'s
    kernel, as its launch runs it: registers a thread, the dynamic shared
    memory allowed and asked, threads a CTA, static shared memory, CTAs
    an SM, the CTAs of a thread-block cluster and the clusters the card
    holds at once (``a``, ``b``, ``c`` pick the variant; each source says
    how).  Launches nothing."""
    out = (ctypes.c_int * len(RESOURCE_FIELDS))()
    fn = function(name, "kernel_resources", [ctypes.c_int] * 3
                  + [ctypes.c_void_p])
    check(fn(a, b, c, ctypes.addressof(out)), f"{name} kernel_resources")
    return dict(zip(RESOURCE_FIELDS, out))


def stream_ptr(device) -> int:
    """The current PyTorch stream on ``device``, as the C side takes it."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
