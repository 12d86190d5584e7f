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
        import repro_torch.tree, repro_torch.wire, repro_torch.net
        import repro_torch.net.endpoint, repro_torch.net.resilience
        import repro_torch.net.transport, repro_torch.wire.frames
        import repro_torch.net.hub, repro_torch.sync
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
    """K1-K5: each wrapper's C entry point is in a ``csrc`` source, and each
    kernel has its plain version beside the wrapper."""
    from repro_torch.kernels import platform
    from repro_torch.kernels.bin_xorsum import (
        bin_parity_xorsum_plain,
        bin_parity_xorsum_units_packed_plain,
        bin_parity_xorsum_units_plain,
    )
    from repro_torch.kernels.gf2_matmul import (
        gf2_matmul_packed_plain,
        gf2_matmul_plain,
        pack_bits_plain,
    )
    from repro_torch.kernels.tow_sketch import tow_sketch_plain
    from repro_torch.kernels.tree_digest import tree_digest_plain

    stems = sorted(p.stem for p in platform.CSRC.glob("*.cu"))
    assert stems == ["bin_xorsum", "gf2_matmul", "tow_sketch"]
    entry_points = {
        "bin_xorsum": ["bin_xorsum_units_launch", "bin_parity_xorsum_launch"],
        "gf2_matmul": ["gf2_pack_launch", "gf2_matmul_packed_launch"],
        "tow_sketch": ["tow_sketch_launch"],
    }
    for stem, names in entry_points.items():
        text = (platform.CSRC / f"{stem}.cu").read_text()
        for name in names:
            assert f'extern "C" int {name}(' in text, (stem, name)
    for plain in (bin_parity_xorsum_units_plain, bin_parity_xorsum_units_packed_plain,
                  bin_parity_xorsum_plain, gf2_matmul_plain, gf2_matmul_packed_plain,
                  pack_bits_plain, tow_sketch_plain, tree_digest_plain):
        assert callable(plain)


def test_no_device_argument_raises_without_a_card():
    import numpy as np

    from repro_torch.kernels.platform import resolve_device
    from repro_torch.recon import ReconcileServer, phase0_numerators, reconcile_batch
    from repro_torch.tree import TreeConfig, level_digests, partition_pair, tree_reconcile

    if torch.cuda.is_available():
        assert ReconcileServer().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ReconcileServer()
    keys = np.arange(1, 50, dtype=np.uint32)
    with pytest.raises(RuntimeError, match="CUDA"):
        partition_pair(keys, keys[1:])
    with pytest.raises(RuntimeError, match="CUDA"):
        tree_reconcile(keys, keys[1:])
    with pytest.raises(RuntimeError, match="CUDA"):
        level_digests(keys, [(0, 1 << 32)], TreeConfig())
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
    root = Path(SRC) / "repro_torch"
    for name in ("kernels/bin_xorsum.py", "kernels/gf2_matmul.py", "kernels/tow_sketch.py",
                 "kernels/tree_digest.py", "kernels/ops.py", "kernels/platform.py",
                 "tree/partition.py"):
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


def test_ledgers_count_exactly_from_many_threads():
    """A wire pair launches kernels from two threads at once: the launch and
    variant ledgers lose no count when several threads update them."""
    import sys
    import threading

    from repro_torch.kernels import platform

    platform.reset_launch_counts()
    before = platform.retrace_count()
    n_threads, per_thread = 8, 2000
    start = threading.Barrier(n_threads)

    def work(i):
        start.wait()
        for j in range(per_thread):
            platform.count_launch("k", (j % 3,))
            platform.count_launch(f"k{i}", (1,))
            platform.note_variant("threads", (i, j % 50))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)           # switch threads as often as possible
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        sys.setswitchinterval(interval)
    counts, shapes = platform.launch_counts(), platform.launch_shapes()
    assert counts["k"] == n_threads * per_thread
    assert sum(shapes["k"].values()) == n_threads * per_thread
    assert all(counts[f"k{i}"] == per_thread for i in range(n_threads))
    assert platform.retrace_count() - before == n_threads * 50
    platform.reset_launch_counts()
    platform.clear_variant_ledger()
