"""``repro_torch.roofline``: the dispatch-mode counter behind the dry run.

The counter's rules (its module docstring) are held on toy functions where
the answer is known to the byte: a matrix product's flops (equal to
``FlopCounterMode``'s), views free, a gather 2 × its result or its result
and its smaller source, an in-place window write 2 × its update, an
elementwise op its operands and result, an upload nothing, and the peak of
a known alloc/free sequence.  Then the depth-weighted count
(``depth_weighted``: each layer group traced at depth 1 and 2) against a
trace of the whole depth, for the ten smoke configs × {train, prefill,
decode}, each group deeper than the traced depths (2 and 3): flops and
bytes equal (linear in depth at smoke width, where no optimizer leaf is
padded to whole update chunks).  The arguments' bytes are given whole,
as the dry run gives them.  The peak is held within 0.25 %: a small
stacked leaf is charged the 512-byte allocator granule, which is not
linear in its layer count (a few KB here, nothing at full width); and
within 2 % for recurrentgemma-2b's training step, where a moment of the
step other than at 2 and 3 periods sets the peak at 4 (-1.56 %, the
depth-weighted count the lower).  The memo of meta results changes no
count.  Everything is on meta or
CPU tensors; nothing here needs a card.
"""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.launch.cells as cells
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.roofline import StepCounter, analyze_step, depth_axes, depth_weighted

META = make_local_mesh(device="meta")
F32 = 4


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def count(fn, *args):
    return analyze_step(fn, args)


def test_matmul_flops_are_exact_and_equal_flop_counter_mode():
    a, b, c = meta(32, 48), meta(48, 64), meta(5, 48, 64)

    def fn(a, b, c):
        return a @ b, torch.bmm(a.expand(5, 32, 48), c), torch.addmm(meta(64), a, b)

    with FlopCounterMode(display=False) as fc:
        fn(a, b, c)
    r = count(fn, a, b, c)
    assert r["flops_per_device"] == 2 * 32 * 48 * 64 * (1 + 5 + 1) == fc.get_total_flops()
    assert r["unresolved_dots"] == 0
    assert count(lambda x: x @ x, meta(48))["unresolved_dots"] == 1    # a dot: no formula


def test_views_cost_no_bytes_and_no_storage():
    x = meta(64, 32)

    def fn(x):
        return (x.view(32, 64), x.t(), x.transpose(0, 1), x[:, None].expand(64, 4, 32),
                x[3:9], x[2], x.as_strided((8, 8), (1, 8)), torch.ops.aten.alias(x),
                x.reshape(2048), x.unsqueeze(0).squeeze(0), x.permute(1, 0))

    r = count(fn, x)
    assert r["bytes_per_device"] == 0
    assert r["peak_bytes_per_device"] == r["argument_bytes_per_device"] == 64 * 32 * F32


def test_elementwise_reads_operands_and_writes_result_a_broadcast_once():
    x, row = meta(64, 32), meta(32)
    assert count(lambda x, r: x + r, x, row)["bytes_per_device"] == (2 * 64 * 32 + 32) * F32
    assert count(lambda x: x.float(), meta(64, 32, dtype=torch.bfloat16))[
        "bytes_per_device"] == 64 * 32 * (2 + 4)
    # an expanded operand is read once, not once a repeat
    assert count(lambda r: r.expand(64, 32) * 2.0, row)["bytes_per_device"] == \
        (32 + 64 * 32) * F32


def test_a_gather_costs_twice_its_result_or_its_result_and_smaller_source():
    table, idx = meta(1000, 16), torch.zeros(10, dtype=torch.long, device="meta")
    assert count(lambda t, i: t.index_select(0, i), table, idx)["bytes_per_device"] == \
        2 * 10 * 16 * F32
    assert count(lambda t, i: t[i], table, idx)["bytes_per_device"] == 2 * 10 * 16 * F32
    # the KV heads repeated to the query heads: the source (2 heads) read once
    kv, heads = meta(4, 2, 128, 8), torch.zeros(12, dtype=torch.long, device="meta")
    got = count(lambda k, h: k.index_select(1, h), kv, heads)["bytes_per_device"]
    assert got == (4 * 12 * 128 * 8 + 4 * 2 * 128 * 8) * F32


def test_an_in_place_window_write_costs_twice_its_update():
    cache, new = meta(4, 2, 1024, 8), meta(4, 2, 1, 8)

    def write(c, n):
        c[:, :, 7:8] = n
        return c

    assert count(write, cache, new)["bytes_per_device"] == 2 * 4 * 2 * 8 * F32
    buf, rows = meta(100, 16), meta(10, 16)
    order = torch.zeros(10, dtype=torch.long, device="meta")
    assert count(lambda b, o, r: b.index_copy_(0, o, r), buf, order, rows)[
        "bytes_per_device"] == 2 * 10 * 16 * F32


def test_an_upload_costs_nothing():
    r = count(lambda: torch.arange(64, dtype=torch.float32).to("meta"))
    assert r["bytes_per_device"] == 0 and r["peak_bytes_per_device"] == 0


def test_peak_follows_a_known_alloc_free_sequence():
    n = 1024                                   # 4 KiB a buffer, a multiple of the granule
    x = meta(n)

    def fn(x):
        a = x * 2                              # arg + a
        b = a + 1                              # arg + a + b: the peak, 3 buffers
        del a
        c = b * 3                              # arg + b + c
        del b
        d = c[: n // 2]                        # a view: nothing new
        return d

    r = count(fn, x)
    assert r["argument_bytes_per_device"] == n * F32
    assert r["peak_bytes_per_device"] == 3 * n * F32
    # a small buffer is charged the allocator's 512-byte granule
    assert count(lambda x: x[:3] * 2, x)["peak_bytes_per_device"] == n * F32 + 512


def test_analyze_step_returns_the_reference_keys_on_one_card():
    from repro.roofline.hlo import analyze_hlo

    r = count(lambda a: a @ a, meta(8, 8))
    assert set(analyze_hlo("", 1)) | {"argument_bytes_per_device",
                                      "peak_bytes_per_device"} == set(r)
    assert r["collective_per_device"] == r["collective_global"] == 0
    assert r["collective_by_op_per_device"] == r["collective_op_counts"] == {}
    with pytest.raises(NotImplementedError, match="multi-card"):
        analyze_step(lambda: None, (), chips=2)


def test_depth_axes_follow_each_layer_plan():
    names = {a: [(n, c) for n, c, _ in depth_axes(get_smoke_config(a))] for a in ARCH_IDS}
    assert names["qwen2-1.5b"] == [("dense", 2)]
    assert names["deepseek-v3-671b"] == [("mla_dense", 1), ("mla_moe", 2)]
    assert names["recurrentgemma-2b"] == [("hybrid_period", 2)]
    assert names["whisper-tiny"] == [("encdec", 2), ("enc", 2)]
    assert names["mamba2-780m"] == [("ssm", 2)]
    full = get_smoke_config("recurrentgemma-2b").scaled(n_layers=8)   # 2 periods + 2 layers
    (_, periods, at), = depth_axes(full)
    assert periods == 2 and at(full, 1).n_layers == 5 and at(full, 3).n_layers == 11


SMOKE_SHAPES = {"train_4k": (2, 48), "prefill_32k": (2, 48), "decode_32k": (2, 48)}
CASES = [(a, s) for a in ARCH_IDS for s in SMOKE_SHAPES]


def cell_count(arch, shape, cfg, memo=None):
    b, s = SMOKE_SHAPES[shape]
    cell = cells.build_cell(arch, shape, META, cfg=cfg, batch=b, seq=s)
    return analyze_step(cell.fn, cell.args, memo=memo)


def deeper(cfg):
    """The smoke config with every depth group past the traced depths (2 and
    3), so that the count extrapolates: 5 layers a group, 4 + 4 for the
    MoE families, 4 periods and the 2 unscanned layers for the hybrid."""
    if cfg.family == "moe":
        return cfg.scaled(n_dense_layers=4, n_layers=8)
    if cfg.family == "hybrid":
        return cfg.scaled(n_layers=4 * len(cfg.pattern) + 2)
    if cfg.family == "encdec":
        return cfg.scaled(n_layers=5, n_enc_layers=4)
    return cfg.scaled(n_layers=5)


@pytest.mark.parametrize("arch,shape", CASES, ids=[f"{a}-{s}" for a, s in CASES])
def test_depth_weighted_count_equals_a_whole_depth_trace(arch, shape):
    cfg = deeper(get_smoke_config(arch))
    assert all(full > 3 for _, full, _ in depth_axes(cfg))
    whole = cell_count(arch, shape, cfg)
    memo = {}
    weighted = depth_weighted(cfg, lambda c: cell_count(arch, shape, c, memo),
                              argument_bytes=whole["argument_bytes_per_device"])
    assert len(weighted["depth_traces"]) == 1 + len(depth_axes(cfg))
    for key in ("flops_per_device", "bytes_per_device", "argument_bytes_per_device",
                "unresolved_dots"):
        assert weighted[key] == whole[key], key
    rtol = 0.02 if (arch, shape) == ("recurrentgemma-2b", "train_4k") else 0.0025
    peak = weighted["peak_bytes_per_device"] / whole["peak_bytes_per_device"] - 1
    assert abs(peak) <= rtol, peak
    assert whole["flops_per_device"] > 0 and whole["bytes_per_device"] > 0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-236b", "whisper-tiny"])
def test_the_memo_changes_no_count(arch):
    cfg = get_smoke_config(arch)
    memo = {}
    for shape in SMOKE_SHAPES:
        cold = cell_count(arch, shape, cfg)
        for _ in range(2):                     # filling the memo, then reading it
            warm = cell_count(arch, shape, cfg, memo)
            assert {k: warm[k] for k in cold if k != "entry"} == \
                {k: cold[k] for k in cold if k != "entry"}, shape
    assert memo


def test_argument_bytes_replace_the_extrapolated_arguments():
    cfg = get_smoke_config("qwen2-1.5b").scaled(n_layers=4)

    def fn(c):
        return cell_count("qwen2-1.5b", "prefill_32k", c)

    plain = depth_weighted(cfg, fn)
    shifted = depth_weighted(cfg, fn, argument_bytes=plain["argument_bytes_per_device"] + 512)
    assert shifted["peak_bytes_per_device"] == plain["peak_bytes_per_device"] + 512
    assert plain["depth_traces"] == [{"dense": 2}, {"dense": 3}]
    # a group no deeper than the base depth is traced whole, once
    whole = depth_weighted(get_smoke_config("qwen2-1.5b"), fn)
    assert whole["depth_traces"] == [{"dense": 2}]


def test_the_counter_is_a_dispatch_mode_that_leaves_results_alone():
    x = torch.randn(4, 4, generator=torch.Generator().manual_seed(0))
    with StepCounter():
        y = x @ x + 1
    torch.testing.assert_close(y, x @ x + 1, rtol=0, atol=0)
