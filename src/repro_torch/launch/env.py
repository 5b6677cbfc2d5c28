"""Host-level launch hardening for a CUDA host (twin of
``repro.launch.env``, without its TF / XLA flags, which configure a stack
the port does not load).

tcmalloc's ``LD_PRELOAD`` only takes effect at process start, so when a
known tcmalloc exists and the process was not already preloaded, the CLI
entry points re-exec themselves once (``reexec=True``; guarded by a marker
env var) -- the in-process equivalent of the shell wrappers that preload it
before python starts (SNIPPETS.md 1-2). Library callers and tests use
``reexec=False``: the variables are set, the process is never replaced.

Opt-out: ``REPRO_NO_ENV_HARDEN=1`` makes the whole thing a no-op.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Optional

_TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
)
_MARKER = "REPRO_ENV_HARDENED"

_DEFAULT_FLAGS = {
    # tcmalloc reports no allocation below this size (a KV cache is large)
    "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000",
}


def find_tcmalloc() -> Optional[str]:
    for path in _TCMALLOC_CANDIDATES:
        if os.path.exists(path):
            return path
    return None


def harden_host_env(*, reexec: bool = False,
                    environ: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Apply the launch-hardening env. Returns {name: value} of every
    variable this call set (empty when opted out or nothing was missing).
    ``environ`` defaults to ``os.environ`` (injectable for tests). With
    ``reexec=True`` (CLI ``__main__`` blocks only: it replaces the process
    image) the process re-execs once with tcmalloc preloaded when one is
    installed."""
    env = os.environ if environ is None else environ
    if env.get("REPRO_NO_ENV_HARDEN") == "1":
        return {}
    applied: Dict[str, str] = {}
    for name, value in _DEFAULT_FLAGS.items():
        if name not in env:
            env[name] = value
            applied[name] = value

    tcmalloc = find_tcmalloc()
    if tcmalloc and tcmalloc not in env.get("LD_PRELOAD", "") \
            and _MARKER not in env:
        preload = " ".join(p for p in (env.get("LD_PRELOAD"), tcmalloc) if p)
        env["LD_PRELOAD"] = preload
        env[_MARKER] = "1"
        applied["LD_PRELOAD"] = preload
        if reexec and environ is None:
            # the dynamic loader reads LD_PRELOAD at process start: replace
            # this process once (the marker guards against loops)
            os.execv(sys.executable, [sys.executable] + sys.argv)
    return applied
