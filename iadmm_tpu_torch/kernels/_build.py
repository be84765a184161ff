"""Build and bind the CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` is compiled by ``nvcc`` into its own shared library with
a plain C interface, loaded with ``ctypes``: pointers and the stream are
passed as ``c_void_p``.  Libraries go to ``iadmm_tpu_torch/_build/`` under
a name keyed by a hash of the sources and flags, so a changed source
rebuilds.  All missing libraries are built at once, one ``nvcc`` process
per source, at the first launch of any kernel.  Every C entry point returns
``cudaGetLastError()``; :func:`check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}  # ptxas register/spill report per source


def header_int(header: str, name: str) -> int:
    """The value of ``constexpr int <name> = <value>;`` in ``csrc/<header>``:
    the tile constants the scratch sizes depend on have one source, the
    header the kernels are compiled from."""
    text = (CSRC / header).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    if len(found) != 1:
        raise RuntimeError(f"{header}: expected one constexpr int {name}")
    return int(found[0])


# Tile constants of csrc/, needed to size the scratch buffers and Ut.
CELL_BM = header_int("cell_gemm.cuh", "BM")   # token rows per cell tile
CELL_HB = {"bfloat16": header_int("cell_gemm.cuh", "HB_BF16"),
           "float32": header_int("cell_gemm.cuh", "HB_F32")}  # units a tile
UT_ALIGN = header_int("cell_gemm.cuh", "UT_ALIGN")  # Ut's row padding
DELTA_HB = header_int("cell_gemm.cuh", "DELTA_HB")  # units a delta partial
# The serving rollout's own cell tile: hidden units a tile, CTAs a cluster
ROLLOUT_HB = header_int("cell_gemm.cuh", "HB_ROLLOUT")
ROLLOUT_CLUSTER = header_int("cell_gemm.cuh", "CL_ROLLOUT")
KKT_ROWS = header_int("kkt_matvec.cuh", "ROWS")  # rows per colpass chunk


def cell_tiles(h: int, gate: str = "bfloat16", hb: int | None = None) -> int:
    """Unit tiles of the cell GEMM at hidden width ``h`` for weights of
    dtype ``gate`` ('bfloat16' or 'float32'), or of ``hb`` units each where
    given (the rollout's ``ROLLOUT_HB``)."""
    return -(-h // (hb or CELL_HB[gate]))


def ut_ld(h: int) -> int:
    """The row length of Ut, and of the rollout's H: ``h`` rounded up to
    ``UT_ALIGN`` (16-byte bf16 rows, as the TMA reads them)."""
    return -(-h // UT_ALIGN) * UT_ALIGN


def row_partials(h: int, gate: str) -> int:
    """The row count of the backward cell's row partials (dxv, dg) at
    hidden width ``h``: one per unit tile for bf16 weights, one per
    ``DELTA_HB`` units for float32 ones (their sums keep that grouping
    whatever the tile)."""
    return cell_tiles(h, gate) if gate == "bfloat16" else delta_partials(h)


def delta_partials(h: int) -> int:
    """The row count of the cell's delta partials at hidden width ``h``
    (both profiles)."""
    return -(-h // DELTA_HB)


def cell_row_tiles(M: int) -> int:
    """Token-row tiles of the cell GEMM over M rows: the row count of the
    backward's column partials."""
    return -(-M // CELL_BM)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _key(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(src: Path) -> Path:
    return BUILD_DIR / f"{src.stem}-{_key(src)}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel; return
    {source stem: library path}."""
    srcs = sorted(CSRC.glob("*.cu"))
    out = {s.stem: _lib_path(s) for s in srcs}
    todo = [s for s in srcs if not out[s.stem].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for s in todo:
        tmp = out[s.stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for s, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[s.stem] = log
        if proc.returncode != 0:
            errors.append(f"{s.name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[s.stem])
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    with _lock:
        if stem not in _libs:
            paths = build_all()
            _libs[stem] = ctypes.CDLL(str(paths[stem]))
        return _libs[stem]


def function(stem: str, name: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(library(stem), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
