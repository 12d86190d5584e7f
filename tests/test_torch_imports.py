"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, and it never falls back to the CPU by itself."""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"},
    )


def test_import_pulls_in_no_jax_and_no_reference_package():
    proc = _run("""
        import sys
        import repro_torch.recon, repro_torch.kernels, repro_torch.obs, repro_torch.core.pbs
        bad = sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith("jax.") or m == "jaxlib"
            or m == "repro" or m.startswith("repro.")
        )
        assert not bad, bad
        assert "torch" in sys.modules
        print("clean")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_sources_name_no_jax_import():
    root = Path(SRC) / "repro_torch"
    files = list(root.rglob("*.py")) + [Path(SRC).parent / "chip_smoke.py"]
    assert len(files) > 18
    for path in files:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (path, line)
            assert not s.startswith(("import repro ", "import repro.", "from repro ",
                                     "from repro.")), (path, line)


def test_every_kernel_has_source_and_plain_version():
    from repro_torch.kernels import platform
    from repro_torch.kernels.bin_xorsum import bin_parity_xorsum_units_plain
    from repro_torch.kernels.gf2_matmul import gf2_matmul_plain
    from repro_torch.kernels.tow_sketch import tow_sketch_plain

    stems = sorted(p.stem for p in platform.CSRC.glob("*.cu"))
    assert stems == ["bin_xorsum_units", "gf2_matmul", "tow_sketch"]
    for plain in (bin_parity_xorsum_units_plain, gf2_matmul_plain, tow_sketch_plain):
        assert callable(plain)


def test_no_device_argument_raises_without_a_card():
    from repro_torch.kernels.platform import resolve_device
    from repro_torch.recon import ReconcileServer, phase0_numerators, reconcile_batch

    if torch.cuda.is_available():
        assert ReconcileServer().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ReconcileServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        reconcile_batch([])
    with pytest.raises(RuntimeError, match="CUDA"):
        phase0_numerators([], [])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"


def test_cuda_tensor_path_never_takes_the_plain_version():
    """The wrappers dispatch on the tensor's device only: with no card, a
    build attempt for a CUDA tensor cannot be reached, and nothing in the
    wrapper modules catches an exception to carry on."""
    root = Path(SRC) / "repro_torch" / "kernels"
    for name in ("bin_xorsum.py", "gf2_matmul.py", "tow_sketch.py", "platform.py"):
        text = (root / name).read_text()
        assert "try:" not in text and "except" not in text, name


def test_variant_and_launch_ledgers():
    from repro_torch.kernels import platform

    platform.clear_variant_ledger()
    before = platform.retrace_count()
    platform.note_variant("probe", (1, 2))
    platform.note_variant("probe", (1, 2))
    platform.note_variant("probe", (1, 3))
    assert platform.retrace_count() - before == 2
    assert platform.retrace_counts()["probe"] >= 2
    platform.reset_launch_counts()
    assert platform.launch_counts() == {}
    platform.count_launch("k", (4, 8))
    platform.count_launch("k", (4, 8))
    platform.count_launch("k", (2, 8))
    assert platform.launch_counts() == {"k": 3}
    assert platform.launch_shapes() == {"k": {(4, 8): 2, (2, 8): 1}}
    platform.reset_launch_counts()
    assert platform.launch_counts() == {} and platform.launch_shapes() == {}
    assert platform.pow2_bucket(5, 8) == 8 and platform.pow2_bucket(1025, 128) == 2048
    assert platform.ceil_to(130, 128) == 256
