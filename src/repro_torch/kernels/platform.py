"""Device resolution, the CUDA kernel loader, and the run ledgers.

Three things every kernel wrapper and executor of the port shares:

* **device resolution** — every entry point takes an explicit ``device``;
  ``None`` means the CUDA card and *raises* when there is none.  Nothing in
  the port carries on on the CPU by itself: CPU execution (the plain
  PyTorch versions) happens only when the caller hands CPU tensors or
  ``device="cpu"``.
* **the kernel loader** — the hand-written CUDA C++ sources under
  ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` at first use, one
  shared library with a plain C interface per source (all compilers
  started together), loaded with ``ctypes``.  The build directory is keyed
  by a hash of the sources, so an edit rebuilds.  A build or load failure
  raises; no path swaps a kernel for its plain version.
* **two ledgers** — the *variant ledger* (``count_retrace`` /
  ``retrace_count``, DESIGN.md §12) counts the first time an executor sees
  a new (entry point, static args, shape bucket) key, so a serving loop can
  assert ``stats["retraces"] == 0`` once its shape buckets are warm; the
  *launch ledger* counts every launch of a hand-written kernel by name, so
  a run can show it really went through the kernels.  Both are guarded by
  one lock: a wire pair launches kernels from two threads at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Variant ledger (the counterpart of a jit-trace census)
# ---------------------------------------------------------------------------

_RETRACES: dict = {"total": 0, "by_fn": {}}
_SEEN_VARIANTS: set = set()
# guards both ledgers' read-modify-writes (not re-entrant: no guarded
# block calls another guarded function)
_LEDGER_LOCK = threading.Lock()


def count_retrace(name: str) -> None:
    """Record one new executor variant of entry point ``name``."""
    with _LEDGER_LOCK:
        _count_retrace(name)


def _count_retrace(name: str) -> None:
    _RETRACES["total"] += 1
    _RETRACES["by_fn"][name] = _RETRACES["by_fn"].get(name, 0) + 1


def note_variant(name: str, key: tuple) -> None:
    """Ledger ``(name, key)`` the first time it is seen.

    ``key`` holds exactly what would select a distinct compiled variant:
    the static arguments and the (bucketed) shapes of the tensor arguments.
    Every executor entry point calls this on every dispatch; only a key not
    seen before in this process counts, so a warm serving loop reads 0.
    """
    k = (name, key)
    with _LEDGER_LOCK:
        if k not in _SEEN_VARIANTS:
            _SEEN_VARIANTS.add(k)
            _count_retrace(name)


def clear_variant_ledger() -> None:
    """Forget every seen variant (the next dispatch of each counts again).
    The monotone totals are kept — callers diff them."""
    with _LEDGER_LOCK:
        _SEEN_VARIANTS.clear()


def retrace_count() -> int:
    """Monotone total of new variants so far; diff two reads to attribute
    them to one run (the ``stats["retraces"]`` mechanism)."""
    return _RETRACES["total"]


def retrace_counts() -> dict:
    """Per-entry-point variant totals (diagnostic view of the same ledger)."""
    with _LEDGER_LOCK:
        return dict(_RETRACES["by_fn"])


# ---------------------------------------------------------------------------
# Launch ledger
# ---------------------------------------------------------------------------

_LAUNCHES: dict = {}
_LAUNCH_SHAPES: dict = {}


def count_launch(name: str, shape: tuple) -> None:
    """Record one launch of hand-written kernel ``name`` at problem size
    ``shape``.  Called by the kernel's wrapper at the launch site and
    nowhere else."""
    with _LEDGER_LOCK:
        _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1
        by_shape = _LAUNCH_SHAPES.setdefault(name, {})
        by_shape[shape] = by_shape.get(shape, 0) + 1


def launch_counts() -> dict:
    """Launches per kernel name since the last reset."""
    with _LEDGER_LOCK:
        return dict(_LAUNCHES)


def launch_shapes() -> dict:
    """``{kernel name: {shape: launches}}`` since the last reset, so a run
    can be measured at exactly the sizes it gave its kernels."""
    with _LEDGER_LOCK:
        return {name: dict(by_shape) for name, by_shape in _LAUNCH_SHAPES.items()}


def reset_launch_counts() -> None:
    with _LEDGER_LOCK:
        _LAUNCHES.clear()
        _LAUNCH_SHAPES.clear()


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


def ceil_to(x: int, mult: int) -> int:
    """Round ``x`` up to a multiple of ``mult`` (block/lane alignment)."""
    return ((x + mult - 1) // mult) * mult


def pow2_bucket(x: int, floor: int) -> int:
    """Round ``x`` up to a power of two, never below ``floor``.

    Shape bucketing for the serving loop (DESIGN.md §5): padding every
    dynamic dimension to a power of two bounds the set of executor variants
    to O(log) per dimension instead of one per distinct workload size.
    """
    v = max(int(x), 1, floor)
    return 1 << (v - 1).bit_length()


# ---------------------------------------------------------------------------
# Devices and uploads
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; anything else -> ``torch.device(device)``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host->device copy of a numpy array.

    uint32 arrays travel as their **int32 bit patterns** (torch's uint32
    has no shifts or indexing); 4 bytes per key either way, so the store
    size and the H2D ledger are what the host arrays say.  On the CPU the
    result is a private copy, never a view of ``arr``.
    """
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    t = torch.from_numpy(arr)
    return t.clone() if device.type == "cpu" else t.to(device)


# ---------------------------------------------------------------------------
# CUDA kernel build + load
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_LIBS: dict = {}


def build_dir() -> Path:
    """Where the kernels build: ``build/repro_torch_kernels/`` at the root of
    the source tree."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_kernels(verbose: bool = False) -> dict:
    """Compile every ``csrc/*.cu`` that is not built yet (one ``nvcc`` per
    source, all started together) and return ``{stem: path of the .so}``."""
    out = build_dir() / _source_key()
    out.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:
        so = out / f"lib{src.stem}.so"
        if so.exists():
            continue
        tmp = out / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC)]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(src)]
        procs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for src, so, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}: nvcc exit {proc.returncode}\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, so)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return {src.stem: out / f"lib{src.stem}.so" for src in sources}


def load_kernel_lib(stem: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<stem>.cu`` (built at first use)."""
    lib = _LIBS.get(stem)
    if lib is None:
        lib = _LIBS[stem] = ctypes.CDLL(str(build_kernels()[stem]))
    return lib


def check_launch(name: str, rc: int) -> None:
    """Raise when a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


_SMS: dict = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once per device)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def current_stream_ptr() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def require(t: torch.Tensor, name: str, dtype, ndim: int, device=None) -> None:
    """Wrapper-side argument check: dtype, rank, contiguity, device."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
