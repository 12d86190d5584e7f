"""How ``chip_smoke.device_ms`` times a wrapper it cannot capture in a CUDA
graph: K4's ragged entry, ``tree_digest_ranges``, which uploads its
host-built work list every call.

    python3 tools/device_ms_probe.py [--out PATH]

Builds the kernels, makes one set of ragged ranges on the card and times
the ragged entry four ways: as ``chip_smoke.py`` does (profiler windows),
every device activity of a call, and both again with ``torch.profiler``
made to miss the kernel (its symbol renamed), so the fallback — events
over back-to-back calls — runs.  Then checks that the graph fallback
refuses this wrapper (the capture raises), and runs ``k4_report`` on the
same ranges with and without the forced miss.  Prints one JSON line, then
the card's name and power limit.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402  (exits where no card is visible)
import torch  # noqa: E402

REPORT_KEYS = ("max_abs_err", "ms", "device_ms", "device_ms_by", "ragged_all_device_ms",
               "padded_device_ms")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", metavar="PATH", default=None, help="also write the line to PATH")
    args = ap.parse_args()
    libs = cs.platform.build_kernels(verbose=False)
    sass = cs.sass_inner_loops(libs["tow_sketch"])
    g = torch.Generator(device=cs.DEV)
    g.manual_seed(0)
    keys, lo, cnt, seeds, width = cs.ranges_case(g, [5000, 0, 300, 70000, 12] * 4)
    ell = seeds.shape[0]

    def call():
        return cs.tree_digest_ranges(keys, lo, cnt, seeds, ell=ell, width=width)

    shape = (len(cnt), width, ell)
    captured, launched = {shape: (keys, lo, cnt, seeds, width)}, {shape: 1}
    out = {"shape": list(shape), "valid": int(cnt.sum()),
           "profiled": cs.device_ms(call, "tree_digest", capturable=False),
           "profiled_every_activity": cs.device_ms(call, "tree_digest", every_activity=True,
                                                   capturable=False)}
    report = cs.k4_report(captured, launched, sass)
    out["k4_report"] = {k: report.get(k) for k in REPORT_KEYS}
    symbols = cs.SYMBOLS["tree_digest"]
    cs.SYMBOLS["tree_digest"] = ("no_such_kernel",)
    try:
        out["missed"] = cs.device_ms(call, "tree_digest", capturable=False)
        out["missed_every_activity"] = cs.device_ms(call, "tree_digest", every_activity=True,
                                                    capturable=False)
        try:
            cs.device_ms(call, "tree_digest")
            out["graph_fallback"] = "captured"
        except RuntimeError as e:
            out["graph_fallback"] = f"refused: {str(e)[:100]}"
        report = cs.k4_report(captured, launched, sass)
        out["k4_report_missed"] = {k: report.get(k) for k in REPORT_KEYS}
    finally:
        cs.SYMBOLS["tree_digest"] = symbols
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(cs.sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))


if __name__ == "__main__":
    main()
