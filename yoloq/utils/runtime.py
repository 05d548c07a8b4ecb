"""Process set-up shared by the CLI, the benchmark and the scripts.

- ``setup_compile_cache``: JAX's persistent compilation cache.  Where
  ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing is set
  here; otherwise the cache lives at the fixed path ``<checkout>/build/
  jax_cache``, so that every process of a checkout finds what another one
  compiled.
- ``device_report``: what a result was measured on — JAX's platform,
  device kind and count, and the card's name and power limit as
  ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import os
import shutil
import subprocess

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, "build", "jax_cache")


def compile_cache_dir(environ=None) -> str:
    """The directory the compile cache uses: the environment's, else the
    checkout's fixed one."""
    environ = os.environ if environ is None else environ
    return environ.get(CACHE_ENV) or DEFAULT_CACHE_DIR


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``compile_cache_dir()``;
    returns that directory.  Call before the first compilation."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def parse_name_power(line: str) -> tuple[str, float]:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> (name, watts)."""
    name, power = (part.strip() for part in line.strip().rsplit(",", 1))
    return name, float(power.split()[0])


def gpu_name_power() -> list[tuple[str, float]]:
    """(name, power limit in W) of every card ``nvidia-smi`` lists; empty
    where there is no ``nvidia-smi``."""
    if shutil.which("nvidia-smi") is None:
        return []
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [parse_name_power(line) for line in out.splitlines() if line.strip()]


def device_report() -> dict:
    """Platform, device kind and count as JAX reports them, plus the cards'
    ``name, power.limit`` lines from ``nvidia-smi``."""
    import jax

    dev = jax.devices()
    return {
        "platform": dev[0].platform,
        "kind": dev[0].device_kind,
        "count": len(dev),
        "nvidia_smi": [f"{n}, {w:.2f} W" for n, w in gpu_name_power()],
    }
