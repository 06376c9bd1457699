"""Persistent XLA compilation cache.

A fresh process compiles every device program on its first call; JAX's
persistent compilation cache stores the compiled executables on disk,
so later processes load them instead.  The cache lives where
JAX_COMPILATION_CACHE_DIR says when that is set (JAX reads it itself),
and otherwise at one fixed path inside the checkout, `<repo>/.jax_cache/`
(the path is part of what makes a later process find its entries).

Every module that jits device code calls enable() before defining its
jitted entry points; it is idempotent and must run before the first
compilation (entries compiled earlier are simply not cached).
"""

from __future__ import annotations

import os

_enabled = False

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache uses under the rule above."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable() -> None:
    global _enabled
    if _enabled:
        return
    _enabled = True
    # CPU compiles are fast, and reloading CPU executables across
    # machine types trips XLA's feature checks (risk of SIGILL): no
    # cache when the platform routing pins the CPU (tests, virtual-mesh
    # dry runs).
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats.split(",")[0].strip().lower() == "cpu":
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    # cache every entry, however small or quick to compile
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
