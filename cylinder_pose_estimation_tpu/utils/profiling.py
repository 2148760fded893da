"""Measurement helpers: which card a number was taken on, and traces.

The reference's only profiling is commented-out line_profiler / MATLAB
profiler hooks (SURVEY.md §5).  Here:

  * ``require_gpu`` -- the JAX GPU devices a measurement runs on; it exits
    rather than fall back to the CPU, so no CPU time is ever reported as a
    device time.
  * ``card_info`` -- each card's name and power limit from ``nvidia-smi``
    (run as a child process that does not use JAX); a card set below its
    maximum power runs slower, so every number carries it.
  * ``device_record`` -- the fields every printed result carries.
  * ``trace`` -- context manager around jax.profiler for TensorBoard traces.
"""

from __future__ import annotations

import contextlib
import subprocess

import jax


def require_gpu(n_cards: int = 1) -> list:
    """The first ``n_cards`` JAX devices; exits naming the missing GPU when
    JAX's default backend is not a GPU or has fewer devices."""
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n_cards:
        raise SystemExit(
            f"needs {n_cards} NVIDIA GPU(s), but JAX found {len(devs)} "
            f"{devs[0].platform} device(s) and no usable GPU"
        )
    return devs[:n_cards]


def card_info() -> list[str]:
    """One 'name, power.limit' line per card, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi listed no card")
    return lines


def device_record(devs: list, card_line: str) -> dict:
    """platform, device kind, device count, card name and power limit."""
    name, _, limit = card_line.partition(",")
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": name.strip(),
        "power_limit": limit.strip(),
    }


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view with TensorBoard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
