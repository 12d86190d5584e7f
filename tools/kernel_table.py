"""The per-path numbers of every kernel from a ``chip_smoke.py`` log.

    python3 tools/kernel_table.py chiprun_out/<run>.jsonl

Reads the ``{"kernels": [...]}`` line and each path's launch counts, and
prints one markdown row a kernel and path: the headline launch, events
``ms``, ``device_ms``, ``bound_ms`` (by), ``plain_ms``, ``library_ms``,
launches and the path's device time over every launch (Σ launches ×
``device_ms`` over the shapes it launched), with the phase seconds of the
run after them.
"""
import json
import sys


def rows(rep: dict, path: str):
    """One row for ``rep``, a kernel's report on one path."""
    shapes = rep["launched_shapes"]
    total = rep.get("sum_device_ms", sum(r["device_ms"] * r["launches"] for r in shapes))
    lib = rep.get("library_ms")
    head = json.dumps(rep["shapes"], separators=(",", ":"))
    return (f"| {path} | {head} | {rep['ms']:.4g} | {rep['device_ms']:.4g} | "
            f"{rep['bound_ms']:.3g} ({rep['bound_by']}) | {rep.get('plain_ms', 0):.4g} | "
            f"{'—' if lib is None else f'{lib:.4g}'} | {sum(r['launches'] for r in shapes)} "
            f"({len(shapes)} shapes) | {total:.4g} | {rep['max_abs_err']} |")


def main(path: str) -> None:
    lines = [json.loads(x) for x in open(path) if x.startswith("{")]
    kernels = next(x["kernels"] for x in lines if "kernels" in x and "phase" not in x)
    print("| kernel | path | headline launch | ms | device_ms | bound_ms | plain_ms | "
          "library_ms | launches | Σ device_ms | max_abs_err |")
    print("| --- " * 11 + "|")
    for k in kernels:
        home = [p for p, n in k.get("launches_by_path", {}).items()
                if p not in k.get("other_paths", {})]
        print(f"| {k['name']} " + rows(k, home[0] if home else "home"))
        for p, rep in k.get("other_paths", {}).items():
            print(f"| {k['name']} " + rows(rep, p))
    print()
    for k in kernels:
        print(k["name"], "launches by path:", k.get("launches_by_path"))
    for x in lines:
        secs = {s: v for s, v in x.items()
                if (s == "seconds" or s.endswith("_phase_s")) and isinstance(v, float)}
        if x.get("phase") and secs and not x.get("step"):
            print(x["phase"], secs)


if __name__ == "__main__":
    main(sys.argv[1])
