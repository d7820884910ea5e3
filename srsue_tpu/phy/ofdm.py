"""OFDM modulation/demodulation: CP insertion/removal + (I)FFT + subcarrier
(de)mapping — the batched replacement of srsLTE's per-symbol FFT consumed via
``srslte_ue_dl_decode_fft_estimate`` (ue/src/phy/phch_worker.cc:254).

Design: whole subframes are processed as one batched FFT of shape
[..., n_sym, nfft]. All CP handling and subcarrier (de)mapping is **pure
static slicing + concat** — symbol start offsets and the DC-skipping
spectrum layout are compile-time constants per Cell, so no gather/scatter
ops appear at all (slices are cheaper). The FFT is XLA's own (cuFFT on a
GPU). The DL resource grid convention
is ``grid[..., n_sym_sf, n_sc]`` with DC skipped (36.211 §6.12).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from .cell import Cell


@functools.lru_cache(maxsize=32)
def symbol_starts(cell: Cell) -> tuple[int, ...]:
    """Start sample of each OFDM symbol's data part (after its CP) within
    one subframe."""
    starts = []
    t = 0
    for _slot in range(2):
        for cp in cell.cp_lengths:
            t += cp
            starts.append(t)
            t += cell.nfft
    assert t == cell.sf_len
    return tuple(starts)


def demodulate(cell: Cell, sf_samples: jnp.ndarray) -> jnp.ndarray:
    """Time-domain subframe(s) -> resource grid.

    [..., sf_len] complex -> [..., n_sym_sf, n_sc] complex.
    """
    nfft = cell.nfft
    sym_td = jnp.stack(
        [sf_samples[..., s : s + nfft] for s in symbol_starts(cell)], axis=-2
    )
    sym_fd = jnp.fft.fft(sym_td, axis=-1) * (1.0 / np.sqrt(nfft))
    half = cell.n_sc // 2
    # sc 0..half-1 <- bins nfft-half.. ; sc half.. <- bins 1..half
    neg = sym_fd[..., nfft - half :]
    pos = sym_fd[..., 1 : half + 1]
    return jnp.concatenate([neg, pos], axis=-1).astype(jnp.complex64)


def modulate_np(cell: Cell, grid: np.ndarray) -> np.ndarray:
    """Host-numpy OFDM modulator twin (eNB-side waveform generation —
    keeps test-vector creation off the device entirely)."""
    nfft = cell.nfft
    n_sym = cell.n_sym_sf
    half = cell.n_sc // 2
    lead = grid.shape[:-2]
    fd = np.zeros(lead + (n_sym, nfft), dtype=np.complex64)
    fd[..., 1 : half + 1] = grid[..., half:]
    fd[..., nfft - half :] = grid[..., :half]
    td = np.fft.ifft(fd, axis=-1).astype(np.complex64) * np.sqrt(nfft)
    pieces = []
    cps = list(cell.cp_lengths) * 2
    for s in range(n_sym):
        cp = cps[s]
        sym = td[..., s, :]
        pieces.append(sym[..., nfft - cp :])
        pieces.append(sym)
    return np.concatenate(pieces, axis=-1).astype(np.complex64)


def demodulate_np(cell: Cell, sf_samples: np.ndarray) -> np.ndarray:
    """Host-numpy OFDM demodulator twin (reference cross-check in tests)."""
    nfft = cell.nfft
    sym_td = np.stack(
        [sf_samples[..., s : s + nfft] for s in symbol_starts(cell)], axis=-2
    )
    sym_fd = np.fft.fft(sym_td, axis=-1) / np.sqrt(nfft)
    half = cell.n_sc // 2
    return np.concatenate(
        [sym_fd[..., nfft - half :], sym_fd[..., 1 : half + 1]], axis=-1
    ).astype(np.complex64)


def modulate(cell: Cell, grid: jnp.ndarray) -> jnp.ndarray:
    """Resource grid -> time-domain subframe (the eNB-side dual, used for
    test-vector generation and the UL chain shape).

    [..., n_sym_sf, n_sc] complex -> [..., sf_len] complex.
    """
    nfft = cell.nfft
    n_sym = cell.n_sym_sf
    half = cell.n_sc // 2
    lead = grid.shape[:-2]
    zdc = jnp.zeros(lead + (n_sym, 1), dtype=jnp.complex64)
    zguard = jnp.zeros(lead + (n_sym, nfft - cell.n_sc - 1), dtype=jnp.complex64)
    fd = jnp.concatenate(
        [zdc, grid[..., half:], zguard, grid[..., :half]], axis=-1
    ).astype(jnp.complex64)
    td = jnp.fft.ifft(fd, axis=-1) * np.sqrt(nfft)

    pieces = []
    cps = list(cell.cp_lengths) * 2
    for s in range(n_sym):
        cp = cps[s]
        sym = td[..., s, :]
        pieces.append(sym[..., nfft - cp :])
        pieces.append(sym)
    return jnp.concatenate(pieces, axis=-1).astype(jnp.complex64)
