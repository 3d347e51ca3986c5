"""``python -m kube_gpu_stats_tpu_torch.sims <name>|all [options]``."""

from __future__ import annotations

import argparse
import importlib
import logging
import sys

from . import SIMS


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kube_gpu_stats_tpu_torch.sims",
        description="Whole-system fault sims over the port's daemons and "
                    "hubs (CPU, fakes).")
    sub = parser.add_subparsers(dest="sim", required=True)
    modules = {}
    for name in SIMS:
        module = importlib.import_module(f".{name}", __package__)
        modules[name] = module
        module.add_arguments(sub.add_parser(
            name, help=module.__doc__.splitlines()[0]))
    sub.add_parser("all", help="every sim with its defaults, in order")
    parser.add_argument("--log-level", default="ERROR")
    args = parser.parse_args(argv)
    logging.basicConfig(level=args.log_level.upper())
    names = SIMS if args.sim == "all" else (args.sim,)
    failed = []
    for name in names:
        sim_args = args if args.sim == name else \
            sub.choices[name].parse_args([])
        if not modules[name].main(sim_args).ok:
            failed.append(name)
    if args.sim == "all":
        print(f"sims: {len(names) - len(failed)} of {len(names)} passed"
              + (f"; failed: {', '.join(failed)}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
