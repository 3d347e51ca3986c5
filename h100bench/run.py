"""Run one cell of the benchmark once.

    python h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program. The cell's
configuration names its driver (``h100bench/drivers/<driver>.py``), which
sets the deployment up, warms it, runs the window and judges what the
program produced against the plain reference. With ``--trace 0`` the cell's
end-to-end metrics are reported, with ``--trace 1`` its per-layer metrics,
each read by ``h100bench/metrics/<name>.py``.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` (traced
runs) and last ``checks``, each compared number with its limit; the same
numbers are the last lines on standard error. Without a CUDA card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
in this process or in any of its children once the window has closed, the
run exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100bench.core import card, common, manifest  # noqa: E402
from h100bench.core import trace as tracemod  # noqa: E402
from h100bench.core.isolation import forbidden_modules  # noqa: E402


class Forbidden(RuntimeError):
    """A process of the run held JAX or the JAX package after the window."""


def check_children(held: dict) -> None:
    """Raise ``Forbidden`` naming each child (``held``: child -> the
    forbidden modules it reported) that held one."""
    found = [f"{', '.join(names)} in the {child}"
             for child, names in sorted(held.items()) if names]
    if found:
        raise Forbidden("loaded " + "; ".join(found))


def measure(cell: manifest.Cell, chips: int, seed: int, seconds: float,
            trace: bool, device: str, kind: str, power_limit_w: float | None,
            t_start: float) -> dict:
    """Run ``cell`` once and build its result (without the chip check)."""
    common.START = t_start
    tmpdir = tempfile.mkdtemp(prefix="h100bench-")
    try:
        driver = manifest.driver(cell.config["driver"])
        res = driver.run(cell, seed, seconds, trace, device, tmpdir)
        traced = (tracemod.load(res["trace_path"])
                  if res.get("trace_path") else None)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    check_children(res["forbidden"])
    scrapes = res["scrapes"]
    common.report_scrapes(scrapes)
    ctx = {
        "cell": cell.name, "seed": seed, "seconds": seconds,
        "setup_s": res["t0"] - t_start, "window_s": res["t1"] - res["t0"],
        "steps": res["steps"], "size": res["size"], "scrapes": scrapes,
        "counters": common.counters(scrapes), "trace": traced,
        "peaks": common.peaks(kind), "power_limit_w": power_limit_w,
    }
    metrics = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(metric["name"])(ctx)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    checks = dict(res["checks"])
    checks["bad_bodies"] = [sum(1 for s in scrapes if s["bad_body"]),
                            cell.config["limits"]["bad_bodies"]]
    out = {
        "correct": all(value <= limit for value, limit in checks.values()),
        "attempted": len(scrapes),
        "failed": sum(1 for s in scrapes if not s["ok"]),
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": kind, "count": chips,
                   "memory_peak_bytes": res["memory_peak_bytes"],
                   "power_limit_w": power_limit_w},
    }
    if traced is not None and traced.ops:
        out["device"]["busy_s"] = traced.busy_us / 1e6
        out["device"]["window_s"] = traced.window_us / 1e6
        out["breakdown"] = tracemod.breakdown(traced)
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, (value, limit) in checks.items()}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = manifest.load(ROOT / "BENCHMARK.json")
    cell = manifest.resolve(bench, ROOT, args.workload)
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    common.START = T_START
    try:
        kind = manifest.driver(cell.config["driver"]).check_card(chips)
    except card.NoCard as exc:
        print(f"h100bench: no result: {exc}", file=sys.stderr)
        return 2
    common.mark("card checked")
    power_limit_w = float(common.smi("power.limit")[0])
    common.mark("power limit read")
    try:
        out = measure(cell, chips, args.seed, args.seconds, bool(args.trace),
                      "cuda", kind, power_limit_w, T_START)
        check_children({"process that prints the result":
                        forbidden_modules()})
    except Forbidden as exc:
        print(f"h100bench: no result: {exc}", file=sys.stderr)
        return 3
    for name, check in out["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
