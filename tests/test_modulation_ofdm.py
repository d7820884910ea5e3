"""Modulation mapper/demapper and OFDM round-trip tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from srsue_tpu.phy import modulation, ofdm
from srsue_tpu.phy.cell import MOD_16QAM, MOD_64QAM, MOD_QPSK, Cell


@pytest.mark.parametrize("m", [MOD_QPSK, MOD_16QAM, MOD_64QAM])
def test_constellation_unit_energy(m):
    tab = modulation.constellation(m)
    assert tab.shape == (1 << m,)
    np.testing.assert_allclose(np.mean(np.abs(tab) ** 2), 1.0, atol=1e-6)


@pytest.mark.parametrize("m", [MOD_QPSK, MOD_16QAM, MOD_64QAM])
def test_mod_demod_roundtrip_noiseless(m):
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 8 * 120 * m).astype(np.uint8).reshape(8, -1)
    sym = modulation.modulate(jnp.asarray(bits), m)
    hard = modulation.demodulate_hard(sym, m)
    np.testing.assert_array_equal(np.asarray(hard), bits)


@pytest.mark.parametrize("m", [MOD_QPSK, MOD_16QAM, MOD_64QAM])
def test_soft_llr_sign_and_scaling(m):
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 600 * m).astype(np.uint8)
    sym = modulation.modulate(jnp.asarray(bits), m)
    # mild noise: LLR signs should still mostly match bits
    noisy = sym + 0.02 * (rng.standard_normal(sym.shape) + 1j * rng.standard_normal(sym.shape))
    llr = np.asarray(modulation.demodulate_soft(jnp.asarray(noisy), m, noise_var=2 * 0.02**2))
    assert llr.shape == (600 * m,)
    signs = (llr < 0).astype(np.uint8)
    assert (signs == bits).mean() > 0.99
    # scaling: smaller noise_var -> larger |LLR|
    llr2 = np.asarray(modulation.demodulate_soft(jnp.asarray(noisy), m, noise_var=0.02**2))
    assert np.mean(np.abs(llr2)) > 1.5 * np.mean(np.abs(llr))


def test_maxlog_llr_matches_exhaustive():
    """Demapper must equal brute-force max-log over the full constellation."""
    m = MOD_64QAM
    tab = modulation.constellation(m)
    words = np.arange(1 << m)
    bits_tab = (words[:, None] >> np.arange(m - 1, -1, -1)[None, :]) & 1
    rng = np.random.default_rng(4)
    y = (rng.standard_normal(50) + 1j * rng.standard_normal(50)).astype(np.complex64)
    d2 = np.abs(y[:, None] - tab[None, :]) ** 2
    want = np.empty((50, m), np.float32)
    for b in range(m):
        m0 = np.min(np.where(bits_tab[None, :, b] == 0, d2, np.inf), axis=1)
        m1 = np.min(np.where(bits_tab[None, :, b] == 1, d2, np.inf), axis=1)
        want[:, b] = m1 - m0
    got = np.asarray(modulation.demodulate_soft(jnp.asarray(y), m, noise_var=1.0))
    np.testing.assert_allclose(got.reshape(50, m), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_prb", [6, 25, 100])
def test_ofdm_roundtrip(n_prb):
    cell = Cell(n_prb=n_prb, cell_id=1)
    rng = np.random.default_rng(5)
    grid = (
        rng.standard_normal((2, cell.n_sym_sf, cell.n_sc))
        + 1j * rng.standard_normal((2, cell.n_sym_sf, cell.n_sc))
    ).astype(np.complex64)
    td = ofdm.modulate(cell, jnp.asarray(grid))
    assert td.shape == (2, cell.sf_len)
    back = ofdm.demodulate(cell, td)
    np.testing.assert_allclose(np.asarray(back), grid, atol=1e-3)


def test_ofdm_sf_len_standard():
    # 20 MHz: 30.72 Msps * 1 ms = 30720 samples; 1.4 MHz: 1920
    assert Cell(n_prb=100).sf_len == 30720
    assert Cell(n_prb=6).sf_len == 1920
    assert Cell(n_prb=6).srate == 1.92e6


def test_ofdm_cp_is_cyclic():
    cell = Cell(n_prb=6)
    grid = np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)
    grid[0, 3] = 1.0
    td = np.asarray(ofdm.modulate(cell, jnp.asarray(grid)))
    cp0 = cell.cp_lengths[0]
    # CP of symbol 0 equals its tail
    np.testing.assert_allclose(td[:cp0], td[cell.nfft : cp0 + cell.nfft], atol=1e-6)
