"""Persistent XLA compilation cache.

Every fresh process compiles the programs the previous one already built.
JAX's persistent compilation cache serializes executables to disk, so repeat
CLI runs, an encode followed by its decode, and serve restarts skip those
compiles. (The reference has no analog — PyTorch eager pays no compile.)

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory. Otherwise the cache lives in one fixed directory
inside the checkout, ``.jax_cache/`` (git-ignored): a fixed path, so every
process of this checkout finds what the others wrote.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses in this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_hang_diagnostics() -> None:
    """Register SIGUSR1 to dump all Python thread stacks to stderr.

    A long run that hangs inside a device call shows no state;
    `kill -USR1 <pid>` then shows where every thread is blocked.
    Registered by the CLI/server/sweep entry points."""
    import faulthandler
    import signal

    try:
        faulthandler.register(signal.SIGUSR1, all_threads=True)
    except (AttributeError, ValueError):
        pass  # non-main thread or platform without SIGUSR1


def enable_compilation_cache() -> str:
    """Idempotently enable the on-disk compilation cache and return its
    directory. Call before the first jit execution (importing jax is fine)."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    # persist every program, however small: a CLI process compiles dozens of
    # sub-second programs, and the default 1 s floor would skip them all
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir()
