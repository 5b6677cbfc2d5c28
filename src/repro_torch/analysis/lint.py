"""Kernel-contract lint CLI of the port (twin of ``repro.analysis.lint``).

    PYTHONPATH=src python -m repro_torch.analysis.lint \\
        --config phi4-mini-3.8b --schedule rotate_once --schedule revisit --abft
    PYTHONPATH=src python -m repro_torch.analysis.lint --mutation --json -

Builds the lint sites of each named config (``sites.py``: the fused
quant_dot sites at the config's down projection, the bound-spec MLP and the
serving decode / prefill-insert of a scaled ``ServeEngine``), runs every
registered rule and exits 1 on any violation, 0 on none. ``--mutation``
lints the two broken kernels (``mutations.py``) instead: a linter with
teeth exits non-zero there with both mutants among the violations.

Most rules read evidence only the card and ``nvcc`` give (launch counters,
rotation counters, PTX, kernel attributes: ``rules.CARD_RULES``). With
``--device cuda`` (the default) and no CUDA device or no ``nvcc``, the CLI
says so and exits 2 whatever rules are selected: it never lints the CPU in
place of the card. Only an explicit ``--device cpu`` lints the CPU serving
sites, under ``donation``, ``dtype-flow`` and ``deprecated-shim-in-trace``
when only those are selected; a card rule or ``--mutation`` there exits 2
too. No rule that could not run is reported as passed.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence, Tuple

__all__ = ["main", "run", "unavailable"]

DEFAULT_CONFIG = "phi4-mini-3.8b"


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Kernel-contract linter over recorded calls of the port's "
                    "kernels, model and server.")
    ap.add_argument("--config", action="append", default=None,
                    help=f"config name from repro_torch.configs (repeatable; default: "
                    f"{DEFAULT_CONFIG})")
    ap.add_argument("--schedule", action="append", default=None,
                    choices=["rotate_once", "streamed", "revisit"],
                    help="quant_dot schedule(s) to lint (repeatable; default: "
                    "rotate_once)")
    ap.add_argument("--rule", action="append", default=None,
                    help="run only the named rule(s) (default: all)")
    ap.add_argument("--no-serving", action="store_true",
                    help="skip the serving-engine sites (no donation / decode checks)")
    ap.add_argument("--abft", action="store_true",
                    help="also lint the checksum-verified (ABFT) kernel twins")
    ap.add_argument("--mutation", action="store_true",
                    help="lint the two broken kernels instead of the config sites; a "
                    "healthy linter exits non-zero (both mutants flagged)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the report as JSON ('-' for stdout)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the registered rules and exit")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the sites run (default: cuda)")
    return ap


def unavailable(device: str) -> Optional[str]:
    """Why the card's rules cannot run here, or None when they can."""
    import torch

    if device != "cuda":
        return f"--device {device}"
    if not torch.cuda.is_available():
        return "no CUDA device (torch.cuda.is_available() is False)"
    from repro_torch.kernels import build

    try:
        build._nvcc()
    except RuntimeError:
        return "no nvcc to build the counting kernels and their PTX"
    return None


def _emit(report, path: Optional[str]) -> None:
    if not path:
        return
    text = report.to_json()
    if path == "-":
        print(text)
    else:
        with open(path, "w") as f:
            f.write(text + "\n")


def run(argv: Optional[Sequence[str]] = None, extra_sites=()) -> Tuple[int, object, list]:
    """The CLI in process: (exit code, report or None, the sites linted).
    ``extra_sites`` are sites the caller recorded itself (e.g. the serving
    sites of engines it already runs), linted beside the CLI's own."""
    args = _build_parser().parse_args(argv)

    from repro_torch.analysis.rules import CARD_RULES, all_rules, run_rules

    if args.list_rules:
        for name, rule in all_rules().items():
            doc = (rule.__doc__ or "").strip().split("\n")[0]
            print(f"{name:26s} {doc}")
        return 0, None, []
    rules = args.rule or list(all_rules())
    unknown = [r for r in rules if r not in all_rules()]
    if unknown:
        print(f"unknown rule(s): {unknown}; --list-rules to see what's registered",
              file=sys.stderr)
        return 2, None, []
    why = unavailable(args.device)
    if why is not None:
        blocked = sorted(set(rules) & CARD_RULES)
        if args.device == "cuda":
            what = "--device cuda was asked for; --device cpu lints the CPU serving sites"
        elif args.mutation:
            what = "the mutants run only on the card"
        elif blocked:
            what = f"rule(s) {blocked} need the card and nvcc"
        else:
            what = None
        if what is not None:
            print(f"lint: cannot run here ({why}): {what}; nothing is reported as "
                  "passed", file=sys.stderr)
            return 2, None, []

    if args.mutation:
        from repro_torch.analysis.mutations import mutant_sites

        sites = mutant_sites(args.device)
        report = run_rules(sites, rules=args.rule)
        print(report.format_text())
        _emit(report, args.json)
        flagged = {v.site for v in report.violations}
        missed = [s.name for s in sites if s.name not in flagged]
        if missed:
            print(f"WARNING: mutant(s) passed the lint: {missed} -- the rules lost "
                  "their teeth", file=sys.stderr)
        # the fixtures are broken kernels: a healthy linter exits non-zero
        return (1 if report.violations else 0), report, sites

    from repro_torch.analysis.sites import default_sites

    sites = list(extra_sites)
    for config in args.config or [DEFAULT_CONFIG]:
        sites += default_sites(config, args.schedule or ["rotate_once"],
                               serving=not args.no_serving, abft=args.abft,
                               device=args.device)
    report = run_rules(sites, rules=args.rule)
    print(report.format_text())
    _emit(report, args.json)
    return (0 if report.ok else 1), report, sites


def main(argv: Optional[List[str]] = None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
