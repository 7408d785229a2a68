"""Builds and binds the hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point of the
same name.  At first use the source is compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -shared -Xcompiler -fPIC -o <build dir>/<name>-<digest>.so <name>.cu

and loaded with ``ctypes`` (``argtypes`` set, so pointers stay 64-bit).
No PyTorch header is involved: a file builds in seconds.  The build
directory (``src/repro_torch/_build`` unless ``REPRO_TORCH_BUILD_DIR``
names another) is ignored by git; the library name carries a digest of the
sources, so an edited kernel is rebuilt and a stale library never loaded.

A kernel launches on PyTorch's current stream, allocates nothing and does
not synchronize.  The C function returns ``cudaGetLastError()`` and
:meth:`Kernel.launch` raises on a non-zero code — a refused launch (too
many threads, too much shared memory) never runs and a later
``synchronize`` would not report it.  ``Kernel.launches`` counts launches
and nothing else, so a run can prove which kernels its path went through.

Nothing here runs at import: ``nvcc`` and the card are needed only when a
wrapper is handed a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_HEADERS = ("blockell_common.cuh", "warp_scan.cuh", "window_kernels.cuh",
            "window_runs.cuh", "chunk_kernels.cuh", "assembly_common.cuh")
_P, _I = ctypes.c_void_p, ctypes.c_int

_lock = threading.Lock()


def build_dir() -> str:
    return os.environ.get("REPRO_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(CSRC_DIR), "_build")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are compiled from source at first use")


def nvcc_version() -> str:
    out = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[-1]


class Kernel:
    """One CUDA kernel: its source, its C signature, its launch count."""

    def __init__(self, name: str, argtypes: Sequence, replaces: str):
        self.name = name
        self.source = os.path.join(CSRC_DIR, name + ".cu")
        self.argtypes = list(argtypes)
        self.replaces = replaces          # the TPU body this kernel replaces
        self.launches = 0
        self._fn = None

    @property
    def repo_source(self) -> str:
        """Source path relative to the repository root."""
        return "src/repro_torch/csrc/" + self.name + ".cu"

    def _digest(self) -> str:
        h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
        for path in [self.source] + [os.path.join(CSRC_DIR, f)
                                     for f in _HEADERS]:
            with open(path, "rb") as f:
                h.update(f.read())
        return h.hexdigest()[:12]

    def library(self) -> str:
        return os.path.join(build_dir(), f"{self.name}-{self._digest()}.so")

    def compile_command(self, extra: Iterable[str] = ()) -> List[str]:
        return [find_nvcc(), *NVCC_FLAGS, *extra, "-o",
                self.library() + f".{os.getpid()}.tmp", self.source]

    def _bind(self):
        lib = ctypes.CDLL(self.library())
        fn = getattr(lib, self.name)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def function(self):
        if self._fn is None:
            build([self])
        return self._fn

    def launch(self, *args, launches: int = 1) -> None:
        """Launch on the current stream; raise if the launch was refused.
        ``launches`` is how many kernels the entry point starts for these
        arguments."""
        fn = self.function()
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: cudaError {err}")
        self.launches += launches


def build(kernels: Optional[Sequence[Kernel]] = None,
          verbose: bool = False) -> Dict[str, object]:
    """Compile (one ``nvcc`` per source, all started together) and bind the
    given kernels, every registered one by default.  Returns
    ``{"seconds", "compiled", "log"}``; raises ``RuntimeError`` with the
    compiler's output when a source does not build."""
    kernels = list(KERNELS.values()) if kernels is None else list(kernels)
    t0 = time.perf_counter()
    log: Dict[str, str] = {}
    with _lock:
        os.makedirs(build_dir(), exist_ok=True)
        extra = ("-Xptxas", "-v") if verbose else ()
        procs = []
        for k in kernels:
            if k._fn is not None or os.path.exists(k.library()):
                continue
            cmd = k.compile_command(extra)
            procs.append((k, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, cwd=CSRC_DIR)))
        failed = []
        for k, cmd, proc in procs:
            out, _ = proc.communicate()
            log[k.name] = out
            tmp = cmd[cmd.index("-o") + 1]
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
                if os.path.exists(tmp):
                    os.remove(tmp)
            else:
                os.replace(tmp, k.library())
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for k in kernels:
            if k._fn is None:
                k._bind()
    return {"seconds": time.perf_counter() - t0,
            "compiled": [k.name for k, _, _ in procs], "log": log}


KERNELS: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def check_lane_loads(pack, tile_slots: int) -> None:
    """Raise ValueError unless the window stream kernels (K1, K2, K5, K6)
    can read ``pack``: a lane loads four consecutive slots of each slot
    stream at once (16 bytes of a 32-bit stream, 8 of a 16-bit one) and a
    warp 128 slots, so
    a tile's slot count or the k-step (``tile_slots``) must be a multiple
    of 128 and every slot stream must start on a 16-byte boundary."""
    if tile_slots % 128:
        raise ValueError(f"{tile_slots} slots per tile or k-step: the "
                         "stream kernels need a multiple of 128")
    for name in ("vals_l", "vals_u", "col_local", "row_in_win"):
        if getattr(pack, name).data_ptr() % 16:
            raise ValueError(f"pack.{name} must start on a 16-byte boundary "
                             "for the stream kernels' vector loads")


def stream_flags(pack, slots_shape: tuple) -> tuple:
    """``(values are bf16, indices are int16)`` for a pack, after checking
    that its streams have the dtypes, shapes and layout the kernels are
    instantiated for.  ``slots_shape`` is the shape of the four slot
    streams: (NT, S) on the rectangular grid, (total steps, step) on the
    flat grid."""
    vdt, idt = pack.vals_l.dtype, pack.col_local.dtype
    if vdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value streams must be float32 or bfloat16, got {vdt}")
    if idt not in (torch.int32, torch.int16):
        raise TypeError(f"index streams must be int32 or int16, got {idt}")
    for name, want in (("vals_u", vdt), ("ad", vdt), ("row_in_win", idt)):
        if getattr(pack, name).dtype != want:
            raise TypeError(f"pack.{name} is {getattr(pack, name).dtype}, "
                            f"expected {want}")
    slots_shape = tuple(slots_shape)
    shapes = {"vals_l": slots_shape, "vals_u": slots_shape,
              "col_local": slots_shape, "row_in_win": slots_shape,
              "ad": (pack.nt, pack.tm)}
    for name, shape in shapes.items():
        a = getattr(pack, name)
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"pack.{name} must be contiguous {shape}, got "
                             f"{tuple(a.shape)}")
    if max(slots_shape[0] * slots_shape[1], pack.nt * pack.w_pad) >= 2 ** 31:
        raise ValueError("pack too large for the kernels' 32-bit tile math")
    return (vdt == torch.bfloat16, idt == torch.int16)
