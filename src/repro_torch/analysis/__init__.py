"""The kernel-contract linter of the port (twin of ``repro.analysis``):
evidence recorders (``dispatch_trace``: aten ops, launch counters, cache
pointers; ``ptx``: the PTX event order), a decorator-registered rule
registry with the reference's seven contracts (``rules``), lint sites built
through the production entry points (``sites``), the two broken kernels
that prove the rules have teeth (``mutations``), and the
``python -m repro_torch.analysis.lint`` CLI. Nothing here builds or
launches a kernel at import time."""
from repro_torch.analysis.report import Report, Violation
from repro_torch.analysis.rules import Rule, all_rules, register_rule, run_rules
from repro_torch.analysis.sites import (Site, default_sites, kernel_sites, model_sites,
                                        serving_sites)

__all__ = ["Report", "Rule", "Site", "Violation", "all_rules", "default_sites",
           "kernel_sites", "model_sites", "register_rule", "run_rules", "serving_sites"]
