"""Splitting spins over several devices."""

from .sharding import resolve_devices, run_parts, spec_to, split_ranges  # noqa: F401
