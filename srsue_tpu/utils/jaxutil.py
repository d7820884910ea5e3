"""JAX host/device helpers: host copies, IQ layout conversion, gathers
and scatters on the last axis, where the persistent compile cache lives,
and the GPU that measurement paths require."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

CHECKOUT = Path(__file__).resolve().parents[2]


def to_host_complex(x: jnp.ndarray) -> np.ndarray:
    """Device complex array -> host numpy complex64."""
    return np.asarray(x).astype(np.complex64)


def to_host(x) -> np.ndarray:
    """Device array -> host numpy array of the same dtype."""
    return np.asarray(x)


def iq_pairs(x: np.ndarray) -> np.ndarray:
    """Host complex array -> float32 ``[..., 2]`` (re, im) pairs."""
    out = np.empty(x.shape + (2,), np.float32)
    out[..., 0] = x.real
    out[..., 1] = x.imag
    return out


def iq_complex(x: jnp.ndarray) -> jnp.ndarray:
    """Float32 ``[..., 2]`` pairs -> complex64 (inside or outside jit)."""
    return jax.lax.complex(x[..., 0], x[..., 1])


def to_device_complex(x: np.ndarray) -> jnp.ndarray:
    """Host complex array -> device complex64."""
    return jnp.asarray(np.asarray(x, np.complex64))


def cgather(x: jnp.ndarray, idx, axis: int = -1) -> jnp.ndarray:
    """x[..., idx] along `axis`."""
    return jnp.take(x, idx, axis=axis)


def cscatter_set(x: jnp.ndarray, idx, vals: jnp.ndarray) -> jnp.ndarray:
    """x.at[..., idx].set(vals) on the last axis."""
    return x.at[..., idx].set(vals)


def compile_cache_dir(default_subdir: str | None = None) -> str:
    """Where JAX keeps compiled programs: ``JAX_COMPILATION_CACHE_DIR``
    when it is set, otherwise ``<checkout>/.jax_cache`` (or a
    subdirectory of it). The path is part of the cache key, so it stays
    fixed across runs."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = CHECKOUT / ".jax_cache"
    return str(path / default_subdir if default_subdir else path)


def use_compile_cache(default_subdir: str | None = None) -> str:
    """Point JAX's persistent compile cache at ``compile_cache_dir`` and
    return the directory."""
    path = compile_cache_dir(default_subdir)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The first device, which must be a GPU: measurement paths fail
    rather than fall back to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU found: JAX's first device is "
                         f"{dev.platform} ({dev.device_kind})")
    return dev


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (one line per
    card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
