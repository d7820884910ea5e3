"""CRS-based channel estimation — LS at pilots + 2D linear interpolation,
noise/RSRP/RSRQ/SNR estimation.

Reference capability mirrored: srsLTE ``srslte_chest_dl_*`` consumed at
ue/src/phy/phch_worker.cc:359,793-855 (SNR/RSRP/RSRQ/RSSI/noise queries).

Design: interpolation is expressed as two small dense matmuls with
host-precomputed weight matrices — frequency interp W_f [n_sc, n_pilots]
per CRS symbol, then time interp W_t [n_sym, n_crs_sym] — so the whole
estimator is (batch x pilots) @ W^T contractions plus element-wise ops,
with zero data-dependent control flow. The contractions run at HIGHEST
precision: a GPU would otherwise take f32 matmuls in TF32.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from . import regrid
from .cell import Cell

# Pilot-axis denoising before interpolation (r4): plain linear interp
# passes pilot noise through UNREDUCED at the pilots; a 3-tap
# [1, 2, 1]/4 FIR across the LS estimates cuts estimation noise by
# ~4.3 dB (sum w^2 = 0.375) while the bias stays negligible for delay
# spreads well inside the CP: pilots sit every 6 subcarriers, so the
# filter spans 18 SC, and a channel with delay spread d samples ripples
# with period nfft/d subcarriers (d <= CP/4 keeps the ripple period
# >= 4x the filter span). srsLTE's chest has the equivalent
# average-filter option (srslte_chest_dl_set_smooth_filter).
_DENOISE = os.environ.get("SRSUE_TPU_CHEST_DENOISE", "1") == "1"
# Delay-spread-ADAPTIVE filter length (r5, VERDICT r4 item 8): the fixed
# 3-tap FIR trades ~4.3 dB noise for a bias that grows with frequency
# selectivity; on long-delay-spread channels the bias dominates and the
# filter should back off. Per batch element the estimator now picks
# among {raw, 3-tap [1,2,1]/4, 5-tap [1,2,2,2,1]/8} by comparing
# ESTIMATED MSE: noise gain is known per filter (1 / 0.375 / 0.219 of
# sigma^2), and the bias is measured from the pilots themselves (the
# filter-minus-identity kernel applied to the LS pilots, noise
# contribution subtracted). Flat channel -> 5-tap (max denoising);
# moderate selectivity -> 3-tap; heavy selectivity -> raw. Pure
# arithmetic + per-element selects: jit-friendly, no control flow.
_ADAPT = os.environ.get("SRSUE_TPU_CHEST_ADAPT", "1") == "1"
# Phase-aligned time averaging across the subframe's CRS symbols: the
# per-symbol COMMON phase (residual-CFO/Doppler rotation) is estimated
# from the pilots and re-applied after averaging, so the rotation ramp
# is still tracked while the channel SHAPE (static within 1 ms for the
# supported channels) is averaged over n_crs symbols (~ -6 dB more
# estimation noise at 4 CRS symbols).
_TIME_AVG = os.environ.get("SRSUE_TPU_CHEST_TIME_AVG", "1") == "1"


@functools.lru_cache(maxsize=256)
def _freq_interp_matrix(cell: Cell, port: int, crs_sym_i: int) -> np.ndarray:
    """W [n_sc, n_p] linear interpolation (with edge extrapolation) from
    this CRS symbol's pilot subcarriers to all subcarriers."""
    pos = regrid.crs_positions(cell, port, 0)
    syms = regrid.crs_symbols(cell, port)
    sym = syms[crs_sym_i]
    ks = pos[pos[:, 0] == sym][:, 1].astype(np.float64)
    n_p = len(ks)
    w = np.zeros((cell.n_sc, n_p), dtype=np.float32)
    for k in range(cell.n_sc):
        j = np.searchsorted(ks, k)
        if j == 0:
            a, b = 0, 1
        elif j >= n_p:
            a, b = n_p - 2, n_p - 1
        else:
            a, b = j - 1, j
        t = (k - ks[a]) / (ks[b] - ks[a])
        w[k, a] = 1.0 - t
        w[k, b] = t
    return w


@functools.lru_cache(maxsize=256)
def _time_interp_matrix(cell: Cell, port: int) -> np.ndarray:
    """W [n_sym_sf, n_crs_sym] linear interp/extrapolate (clamped at the
    subframe edges) from CRS-bearing symbols to every OFDM symbol."""
    ts = np.asarray(regrid.crs_symbols(cell, port), dtype=np.float64)
    n_t = len(ts)
    w = np.zeros((cell.n_sym_sf, n_t), dtype=np.float32)
    for s in range(cell.n_sym_sf):
        j = np.searchsorted(ts, s)
        if j == 0:
            w[s, 0] = 1.0  # clamp (no extrapolation: steadier at edges)
        elif j >= n_t:
            w[s, n_t - 1] = 1.0
        else:
            a, b = j - 1, j
            t = (s - ts[a]) / (ts[b] - ts[a])
            w[s, a] = 1.0 - t
            w[s, b] = t
    return w


def estimate(cell: Cell, grid: jnp.ndarray, subframe: int, port: int = 0):
    """LS + 2D interpolation channel estimate for one CRS port.

    grid: [..., n_sym_sf, n_sc] complex received resource grid.
    Returns (h [..., n_sym_sf, n_sc] complex64, noise_var [...] float32,
    rsrp [...] float32).
    """
    pos = regrid.crs_positions(cell, port, subframe)
    refs = regrid.crs_values(cell, port, subframe)
    syms = regrid.crs_symbols(cell, port)
    n_per = 2 * cell.n_prb

    flat = grid.reshape(grid.shape[:-2] + (-1,))
    flat_idx = pos[:, 0].astype(np.int64) * cell.n_sc + pos[:, 1]
    y_p = flat[..., jnp.asarray(flat_idx)]  # [..., n_pilot]
    h_ls = y_p * jnp.conj(jnp.asarray(refs)) / jnp.float32(np.mean(np.abs(refs) ** 2))

    # per-CRS-symbol frequency interpolation (stack the small matmuls)
    h_sym = h_ls.reshape(h_ls.shape[:-1] + (len(syms), n_per))

    # noise estimate first (the adaptive selector consumes it): residual
    # of LS pilots vs 3-tap frequency-smoothed pilots
    h_smooth = (
        h_sym
        + jnp.roll(h_sym, 1, axis=-1)
        + jnp.roll(h_sym, -1, axis=-1)
    ) / 3.0
    resid = (h_sym - h_smooth)[..., 1:-1]  # drop wrap-around edges
    # smoothing leaves (1 - 1/3) of noise in resid: var(resid)=2/3 sigma^2
    noise_var = jnp.mean(jnp.abs(resid) ** 2, axis=(-1, -2)) * 1.5

    h_in = h_sym
    if _DENOISE:

        def clamp_shift(x, s):
            if s < 0:
                return jnp.concatenate(
                    [x[..., :1].repeat(-s, axis=-1), x[..., :s]], axis=-1)
            return jnp.concatenate(
                [x[..., s:], x[..., -1:].repeat(s, axis=-1)], axis=-1)

        fir3 = (0.25 * clamp_shift(h_sym, -1) + 0.5 * h_sym
                + 0.25 * clamp_shift(h_sym, 1))
        if not _ADAPT:
            h_in = fir3
        else:
            fir5 = (clamp_shift(h_sym, -2) + 2.0 * clamp_shift(h_sym, -1)
                    + 2.0 * h_sym + 2.0 * clamp_shift(h_sym, 1)
                    + clamp_shift(h_sym, 2)) / 8.0
            # The selector needs a SELECTIVITY-INDEPENDENT noise
            # estimate: the frequency-residual noise_var above is
            # bias-contaminated on selective channels (it would fool
            # the selector into keeping the FIR exactly when it must
            # back off). CRS symbols 2 apart share subcarrier offsets
            # (port-0 v-shift pattern 0,3,0,3), and the channel SHAPE
            # is static within the subframe, so the phase-aligned
            # difference of those time pairs measures pure noise.
            if len(syms) >= 4:
                a = h_sym[..., 0:2, :]
                b = h_sym[..., 2:4, :]
                corr = jnp.sum(b * jnp.conj(a), axis=-1, keepdims=True)
                ph = corr / jnp.maximum(jnp.abs(corr), 1e-12)
                d = b * jnp.conj(ph) - a
                nv = jnp.mean(jnp.abs(d) ** 2, axis=(-1, -2),
                              keepdims=True) * 0.5  # [..., 1, 1]
            else:
                nv = noise_var[..., None, None]
            # measured bias of each filter: |(w - delta) * h|^2 at the
            # interior pilots, known noise contribution subtracted
            # (3-tap residual kernel [1,-2,1]/4 -> 6/16 sigma^2; 5-tap
            # [1,2,-6,2,1]/8 -> 46/64 sigma^2)
            d2 = (h_sym[..., 2:] - 2.0 * h_sym[..., 1:-1]
                  + h_sym[..., :-2])
            b3 = jnp.maximum(
                jnp.mean(jnp.abs(d2) ** 2, axis=(-1, -2), keepdims=True)
                / 16.0 - (6.0 / 16.0) * nv, 0.0)
            r5 = (fir5 - h_sym)[..., 2:-2]
            b5 = jnp.maximum(
                jnp.mean(jnp.abs(r5) ** 2, axis=(-1, -2), keepdims=True)
                - 0.71875 * nv, 0.0)
            # the time-averaging stage downstream reduces NOISE by
            # ~n_crs but leaves filter BIAS untouched — the selector
            # must weigh bias against the POST-averaging noise or it
            # over-filters (measured: picked 5-tap where 3-tap's final
            # MSE was 30% lower)
            n_eff = float(len(syms)) if (_TIME_AVG and len(syms) >= 2) \
                else 1.0
            mse_raw = nv / n_eff
            mse3 = 0.375 * nv / n_eff + b3
            mse5 = 0.21875 * nv / n_eff + b5
            pick3 = (mse3 <= mse_raw) & (mse3 <= mse5)
            pick5 = (mse5 < mse_raw) & (mse5 < mse3)
            h_in = jnp.where(pick5, fir5, jnp.where(pick3, fir3, h_sym))
    h_f = []
    for i in range(len(syms)):
        w = jnp.asarray(_freq_interp_matrix(cell, port, i))
        h_f.append(jnp.matmul(h_in[..., i, :], w.T.astype(jnp.complex64),
                              precision=jax.lax.Precision.HIGHEST))
    h_f = jnp.stack(h_f, axis=-2)  # [..., n_crs_sym, n_sc]

    if _TIME_AVG and len(syms) >= 2:
        # phase-align to the first CRS symbol, average the shape,
        # restore each symbol's phase (see module note)
        ref = h_f[..., :1, :]
        corr = jnp.sum(h_f * jnp.conj(ref), axis=-1, keepdims=True)
        ph = corr / jnp.maximum(jnp.abs(corr), 1e-12)
        h_mean = jnp.mean(h_f * jnp.conj(ph), axis=-2, keepdims=True)
        h_f = h_mean * ph

    wt = jnp.asarray(_time_interp_matrix(cell, port)).astype(jnp.complex64)
    # [..., n_sym_sf, n_sc] = wt [n_sym, n_crs] @ h_f [..., n_crs, n_sc]
    h = jnp.einsum("tc,...cs->...ts", wt, h_f, precision=jax.lax.Precision.HIGHEST)

    rsrp = jnp.mean(jnp.abs(h_ls) ** 2, axis=-1)
    return h.astype(jnp.complex64), noise_var.astype(jnp.float32), rsrp


def metrics(cell: Cell, grid: jnp.ndarray, noise_var, rsrp):
    """RSSI / RSRQ / SNR in the shapes the metrics table expects
    (ue/src/metrics_stdout.cc:98-139)."""
    rssi = jnp.mean(jnp.abs(grid) ** 2, axis=(-1, -2)) * cell.n_sc
    rsrq = 10.0 * jnp.log10(cell.n_prb * rsrp / jnp.maximum(rssi, 1e-12))
    snr_db = 10.0 * jnp.log10(jnp.maximum(rsrp / jnp.maximum(noise_var, 1e-12), 1e-12))
    return {
        "rssi": rssi,
        "rsrq_db": rsrq,
        "snr_db": snr_db,
        "rsrp": rsrp,
        "noise": noise_var,
    }
