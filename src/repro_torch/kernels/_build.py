"""Build and load the port's CUDA kernels.

On first use, ``library()`` compiles every ``csrc/*.cu`` for Hopper
(``nvcc -gencode arch=compute_90a,code=sm_90a -O3``), one ``nvcc`` per
source, all started together, and links them into one shared library
with a plain C interface, loaded with ``ctypes``.  No PyTorch header is
compiled, so a build takes seconds.  The library lands in
``build/repro_torch/<hash of sources and flags>/`` at the root of the
checkout (git-ignored), so an edited source rebuilds and an unchanged
one loads the earlier build.  A failed build raises with the compiler's
output.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
PTXAS_VERBOSE = ("-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    "isax_summarize_launch": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    "lb_scan_launch": (_P, _P, _P, _P, _I, _L, _I, _F, _P),
    "block_topk_launch": (_P, _P, _P, _P, _I, _I, _I, _P),
    "fused_panel_topk_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "fused_panel_topk_scratch_words": (_I, _I, _I),
    "fused_panel_topk_tiles": (_I,),
    "batch_l2_launch": (_P, _P, _P, _I, _L, _I, _P),
    "dtw_band_panel_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "ssm_scan_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _P),
    "ssm_scan_bwd_launch": (_P,) * 17 + (_I, _I, _I, _I, _P),
    "ssm_scan_bwd_scratch": (_I, _I, _I, _I, _I),
    "ssm_scan_ckpt_steps": (),
}
# C entries that return something else than an int status
RESTYPES = {"fused_panel_topk_scratch_words": _L, "ssm_scan_bwd_scratch": _L}
# steps between the states ssm_scan's training launch keeps (kSsmCkpt in
# csrc/ssm_scan.cuh; library() refuses a build that disagrees): the
# wrappers size the checkpoint buffers by it, the plain versions lay
# their checkpoints out by it
SSM_CKPT_STEPS = 32


@dataclasses.dataclass(frozen=True)
class Kernels:
    """The loaded library and what its build reported."""
    lib: ctypes.CDLL
    path: Path
    build_seconds: float        # 0.0 when an earlier build was loaded
    ptxas_log: dict             # source stem -> ptxas -v output


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, from the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> dict:
    """Compile every source in parallel, link, move the library into
    ``out_dir``.  -> {source stem: ptxas log}."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir.parent) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, *PTXAS_VERBOSE, "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs, failed = {}, []
        for src, _, proc in procs:
            out, err = proc.communicate()
            logs[src.stem] = out + err
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib_tmp = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib_tmp),
             *(str(obj) for _, obj, _ in procs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        for stem, text in logs.items():
            (out_dir / f"{stem}.ptxas.log").write_text(text)
        os.replace(lib_tmp, out_dir / LIB_NAME)
    return logs


@functools.lru_cache(maxsize=None)
def library() -> Kernels:
    """Build (if needed) and load the kernels' shared library."""
    out_dir = BUILD_ROOT / _digest()
    path = out_dir / LIB_NAME
    seconds = 0.0
    if path.exists():
        logs = {p.name.split(".")[0]: p.read_text()
                for p in out_dir.glob("*.ptxas.log")}
    else:
        t0 = time.perf_counter()
        logs = _compile(out_dir)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    lib.repro_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    if lib.ssm_scan_ckpt_steps() != SSM_CKPT_STEPS:
        raise RuntimeError(f"the ssm kernels keep a state every "
                           f"{lib.ssm_scan_ckpt_steps()} steps, the wrappers "
                           f"size for {SSM_CKPT_STEPS}")
    return Kernels(lib=lib, path=path, build_seconds=seconds, ptxas_log=logs)


def ptxas_summary(log: str) -> dict:
    """Registers, static shared memory and spills from one ``ptxas -v`` log."""
    def num(pattern):
        m = re.search(pattern, log)
        return int(m.group(1)) if m else None
    return {"registers": num(r"Used (\d+) registers"),
            "smem_bytes": num(r"(\d+) bytes smem"),
            "spill_stores": num(r"(\d+) bytes spill stores"),
            "spill_loads": num(r"(\d+) bytes spill loads")}


def check_status(status: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch)."""
    if status != 0:
        msg = library().lib.repro_cuda_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status}: {msg}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple, device: torch.device | None = None) -> None:
    """Validate one kernel operand: on CUDA (on ``device`` when given),
    of ``dtype``, of ``shape``, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
