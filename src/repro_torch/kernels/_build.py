"""Build ``csrc/*.cu`` with ``nvcc`` on first use and load it with ctypes.

Each source becomes its own shared library with a plain C interface,
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout. The
hash covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so a library is rebuilt only when one of them changes; the
compiler's output is kept beside it (``build_log``).
``build_all`` starts one ``nvcc`` per source, all together. No PyTorch
header is compiled: a build takes seconds, where
``torch.utils.cpp_extension.load`` takes minutes and needs ``ninja``.

The binding helpers at the bottom are shared by the kernel wrappers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("gcn_agg", "edge_score", "flash_attention", "decode_attention",
           "ssm_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or the
    toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Build every library of ``names`` that is missing, one ``nvcc`` per
    source, all started together. Returns ``{name: compiler output}`` for
    the ones built (ptxas' register/spill report). Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"tmp{os.getpid()}-{out.name}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        report[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def build_log(name: str) -> str:
    """nvcc's output (with ptxas' -v report and warnings) from the build
    of kernel ``name``'s current library; "" if it was built without."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def bind(name: str, symbol: str, n_ptr: int, n_int: int):
    """``symbol`` of library ``name`` with ctypes types set: ``n_ptr``
    pointers, then ``n_int`` ints, then the stream; returns a CUDA error
    code (0 on success)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_longlong] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# ------------------------------------------------------------- binding helpers
def device_of(*tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` lie on; raises on a mix."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devices))}")
    return devices.pop()


def check_dtype(names: str, *tensors: torch.Tensor,
                dtypes=(torch.float32,), contiguous: bool = True):
    """Each tensor's dtype is one of ``dtypes`` (and, if ``contiguous``,
    the tensor is contiguous); raises otherwise."""
    for name, t in zip(names.split(), tensors):
        if t.dtype not in dtypes:
            allowed = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise TypeError(f"{name}: the CUDA kernel takes {allowed}, got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes a contiguous tensor")


def check_rows(names: str, *tensors: torch.Tensor):
    """Each tensor's last axis is contiguous and every row starts on a
    16-byte boundary, as the attention kernels' vector loads need."""
    for name, t in zip(names.split(), tensors):
        vec = 16 // t.element_size()
        if (t.stride(-1) != 1 or t.data_ptr() % 16
                or any(st % vec for st in t.stride()[:-1])
                or t.shape[-1] % vec):
            raise ValueError(
                f"{name}: the CUDA kernel reads rows of 16-byte vectors: the "
                f"last axis must be contiguous and every row 16-byte aligned "
                f"(strides {t.stride()}, shape {tuple(t.shape)})")


_sm_counts: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of CUDA ``device`` (cached)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def query(name: str, symbol: str, *args: int) -> int:
    """``symbol`` of library ``name``, a C function of ints that returns a
    long long, called on ``args``; raises on a negative result (minus a
    CUDA error code)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [ctypes.c_longlong] * len(args)
    fn.restype = ctypes.c_longlong
    out = int(fn(*args))
    if out < 0:
        raise RuntimeError(f"{name}: {symbol} failed: CUDA error {-out}")
    return out


def launch(fn, kernel: str, device: torch.device, *args) -> None:
    """Call a bound kernel on PyTorch's current stream of ``device`` and
    raise if the launch was refused."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
