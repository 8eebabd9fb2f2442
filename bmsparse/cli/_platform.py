"""Shared --platform flag for the CLI drivers (cli/spmv.py,
cli/spgemm.py, cli/scaling.py)."""

from __future__ import annotations

import argparse


def add_platform_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--platform", default=None, choices=["cpu", "gpu"],
        help="force the jax backend (default: JAX's own choice)")


def apply_platform(args: argparse.Namespace) -> None:
    """Must run before any jax computation initializes a backend."""
    from ..config import enable_compile_cache

    if getattr(args, "platform", None):
        import jax

        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
