"""Equalization: ZF / MMSE single-port, and TM2 2-port Alamouti (SFBC)
combining — the capability surface of srsLTE's predecoding inside
``srslte_pdsch_decode_rnti`` (README.md:15,17: "ZF and MMSE equalizer",
"transmission mode 1 and 2").

All functions are element-wise over [..., n_re] arrays (they fuse
with the demapper). They return (x_hat, nv_eff): the equalized symbols
and the per-RE effective noise variance to feed the max-log demapper —
this pairing keeps the LLRs correctly scaled for HARQ soft combining.
"""

from __future__ import annotations

import jax.numpy as jnp


def zf(y: jnp.ndarray, h: jnp.ndarray, noise_var) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Zero-forcing: x = y/h, nv_eff = nv/|h|^2 (max-log optimal for SISO)."""
    h2 = jnp.maximum(jnp.abs(h) ** 2, 1e-12)
    x = y * jnp.conj(h) / h2
    nv = jnp.asarray(noise_var)
    # per-batch noise broadcasts over every trailing data dim of h
    # ([B] nvar vs [B, n_re] or [B, n_sym, n_sc] grids)
    while nv.ndim and nv.ndim < h2.ndim:
        nv = nv[..., None]
    nv_eff = nv / h2
    return x, nv_eff


def mmse(y: jnp.ndarray, h: jnp.ndarray, noise_var) -> tuple[jnp.ndarray, jnp.ndarray]:
    """MMSE with bias removal: w = h*/(|h|^2+nv); unbiased x = wy/(w h).
    Equivalent decision metric to ZF in SISO but numerically tamer in deep
    fades (bounded amplification)."""
    nv = jnp.asarray(noise_var)
    h2 = jnp.abs(h) ** 2
    nvb = nv
    while nvb.ndim and nvb.ndim < h2.ndim:
        nvb = nvb[..., None]
    g = h2 / (h2 + nvb)  # bias factor in [0,1)
    x = y * jnp.conj(h) / jnp.maximum(h2 + nvb, 1e-12) / jnp.maximum(g, 1e-6)
    nv_eff = nvb / jnp.maximum(h2, 1e-9)
    return x, nv_eff


def alamouti_combine(
    y: jnp.ndarray, h0: jnp.ndarray, h1: jnp.ndarray, noise_var
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """SFBC (TM2) combining over RE pairs.

    TX mapping (36.211 §6.3.4.3, 2 ports) for symbol pair (x0, x1) on REs
    (2i, 2i+1): port0 sends (x0, x1)/sqrt(2); port1 sends (-x1*, x0*)/sqrt(2).

    y:   [..., n_re] received (n_re even, pair-adjacent REs)
    h0/h1: per-port channel at the same REs.
    Returns combined (x_hat [..., n_re], nv_eff [..., n_re]).
    """
    y0 = y[..., 0::2]
    y1 = y[..., 1::2]
    g0 = 0.5 * (h0[..., 0::2] + h0[..., 1::2])  # channel ~constant over pair
    g1 = 0.5 * (h1[..., 0::2] + h1[..., 1::2])
    p = jnp.abs(g0) ** 2 + jnp.abs(g1) ** 2
    p = jnp.maximum(p, 1e-12)
    # r0 = (g0 x0 - g1 x1*)/sqrt2 ; r1 = (g0 x1 + g1 x0*)/sqrt2
    x0 = (jnp.conj(g0) * y0 + g1 * jnp.conj(y1)) / p * jnp.sqrt(2.0)
    x1 = (jnp.conj(g0) * y1 - g1 * jnp.conj(y0)) / p * jnp.sqrt(2.0)
    x = jnp.stack([x0, x1], axis=-1).reshape(y.shape)
    nv = jnp.asarray(noise_var)
    nvb = nv[..., None] if nv.ndim else nv
    nv_pair = 2.0 * nvb / p  # post-combining noise on unit-energy symbols
    nv_eff = jnp.repeat(nv_pair, 2, axis=-1).reshape(x.shape)
    return x, nv_eff


def alamouti_precode(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """eNB-side SFBC precoding (for test-vector generation): [..., n_sym]
    layer symbols -> per-port RE streams (port0, port1), each [..., n_sym]."""
    x0 = x[..., 0::2]
    x1 = x[..., 1::2]
    s = 1.0 / jnp.sqrt(2.0)
    p0 = jnp.stack([x0, x1], axis=-1).reshape(x.shape) * s
    p1 = jnp.stack([-jnp.conj(x1), jnp.conj(x0)], axis=-1).reshape(x.shape) * s
    return p0, p1
