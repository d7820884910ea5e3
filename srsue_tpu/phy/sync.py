"""Cell search & synchronization — PSS/SSS detection, timing and CFO
estimation (36.211 §6.11).

Capability parity with srsLTE ``ue_sync`` / ``ue_cellsearch`` consumed at
ue/src/phy/phch_recv.cc:96-264 (cell_search -> sync_sfn -> track loop).

Design (no data-dependent control flow inside jit):
* PSS search = FFT-domain circular cross-correlation against the 3 root
  replicas, batched over roots and over search windows: one batched FFT +
  elementwise multiply + IFFT, then a normalized peak pick (argmax) — the
  classic matched filter expressed as dense batched spectral ops.
* SSS identification = one [62] x [62, 2*168] matmul over all candidate
  (N_id_1, half-frame) sequences -> argmax. The "brute force over a tiny
  table as a single matmul" pattern replaces srsLTE's sequential
  m0/m1 decimation search.
* CFO: cyclic-prefix autocorrelation (fractional CFO in subcarrier units)
  + PSS-phase refinement; correction is one elementwise complex rotate.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import seq
from .cell import Cell

SEARCH_NFFT = 128  # PSS search runs at 1.92 Msps (6-PRB geometry)


@functools.lru_cache(maxsize=8)
def pss_time_replica(n_id_2: int, nfft: int = SEARCH_NFFT) -> np.ndarray:
    """Time-domain PSS replica of length nfft (unit energy)."""
    fd = np.zeros(nfft, np.complex64)
    d = seq.pss_freq(n_id_2)
    fd[1:32] = d[31:]
    fd[nfft - 31 :] = d[:31]
    td = np.fft.ifft(fd).astype(np.complex64)
    return (td / np.linalg.norm(td)).astype(np.complex64)


def pss_correlate(samples: jnp.ndarray, nfft: int = SEARCH_NFFT) -> jnp.ndarray:
    """Normalized PSS correlation magnitudes for all 3 roots.

    samples: [..., n] at the search rate. Returns [..., 3, n] where entry
    t is the correlation of the window starting at t (circular at the
    tail).
    """
    n = samples.shape[-1]
    reps = np.stack(
        [
            np.concatenate(
                [np.conj(pss_time_replica(r, nfft))[::-1], np.zeros(n - nfft, np.complex64)]
            )
            for r in range(3)
        ]
    )
    # circular correlation via spectral multiply; index shift so that
    # out[t] = sum_k x[t+k] conj(rep[k])
    x_f = jnp.fft.fft(samples, axis=-1)
    r_f = jnp.fft.fft(jnp.asarray(reps), axis=-1)
    corr = jnp.fft.ifft(x_f[..., None, :] * r_f, axis=-1)
    corr = jnp.roll(corr, -(nfft - 1), axis=-1)
    # normalize by local window energy (approx: global RMS keeps it cheap)
    rms = jnp.sqrt(jnp.mean(jnp.abs(samples) ** 2, axis=-1) + 1e-12)
    return jnp.abs(corr) / (rms[..., None, None] * np.sqrt(nfft))


def find_pss(samples: jnp.ndarray, nfft: int = SEARCH_NFFT):
    """Peak-pick over roots x time. Returns (n_id_2, t_peak, peak_value)
    as device scalars ([...]-shaped for batched input)."""
    c = pss_correlate(samples, nfft)
    flat = c.reshape(c.shape[:-2] + (-1,))
    idx = jnp.argmax(flat, axis=-1)
    n = c.shape[-1]
    return idx // n, idx % n, jnp.max(flat, axis=-1)


def cfo_estimate_cp(samples: jnp.ndarray, nfft: int, cp: int) -> jnp.ndarray:
    """Fractional CFO (in subcarrier units) from CP autocorrelation over
    the leading OFDM symbol(s) of `samples` [..., >= nfft+cp]."""
    a = samples[..., :cp]
    b = samples[..., nfft : nfft + cp]
    r = jnp.sum(b * jnp.conj(a), axis=-1)
    return jnp.angle(r) / (2 * np.pi)


def cfo_correct(samples: jnp.ndarray, cfo: jnp.ndarray | float, nfft: int) -> jnp.ndarray:
    """Rotate out a CFO given in subcarrier units at the array's rate."""
    n = samples.shape[-1]
    t = np.arange(n, dtype=np.float32)
    ph = -2.0 * np.pi * jnp.asarray(cfo)[..., None] * jnp.asarray(t) / nfft
    return samples * jax.lax.complex(jnp.cos(ph), jnp.sin(ph))


@functools.lru_cache(maxsize=4)
def _sss_bank() -> np.ndarray:
    """[3, 62, 336] matched-filter bank: for each n_id_2, columns are the
    candidate SSS sequences for (n_id_1 in 0..167) x (sf0, sf5)."""
    bank = np.zeros((3, 62, 336), np.float32)
    for nid2 in range(3):
        for nid1 in range(168):
            bank[nid2, :, nid1] = seq.sss_freq(nid1, nid2, False)
            bank[nid2, :, 168 + nid1] = seq.sss_freq(nid1, nid2, True)
    return bank


def sss_identify(sss_fd: jnp.ndarray, n_id_2) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Identify N_id_1 and half-frame from the 62 SSS subcarriers.

    sss_fd: [..., 62] frequency-domain SSS REs, ideally pre-equalized by
    the PSS channel estimate (coherent) — raw works at high SNR.
    n_id_2: scalar int (static or traced).
    Returns (n_id_1, is_sf5, score).
    """
    bank = jnp.asarray(_sss_bank())[n_id_2]  # [62, 336]
    # SSS is real-valued (+-1) per subcarrier
    m = jnp.matmul(jnp.real(sss_fd), bank, precision=jax.lax.Precision.HIGHEST)
    best = jnp.argmax(jnp.abs(m), axis=-1)
    return best % 168, best >= 168, jnp.take_along_axis(
        jnp.abs(m), best[..., None], axis=-1
    )[..., 0]


def sss_coherent(
    pss_fd: jnp.ndarray, sss_fd: jnp.ndarray, n_id_2
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Coherent SSS identification: equalize the SSS REs with the channel
    estimated from the PSS symbol (they are one OFDM symbol apart)."""
    d = jnp.asarray(seq.pss_freq(int(n_id_2)))
    h = pss_fd * jnp.conj(d)  # channel * |d|^2 (|d|=1)
    eq = sss_fd * jnp.conj(h)
    return sss_identify(eq, n_id_2)


# ---------------------------------------------------------------------------
# Decimation to the 1.92 Msps search rate
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _lpf_taps(decim: int, ntaps: int = 47) -> np.ndarray:
    """Windowed-sinc low-pass for decimation by `decim` (cutoff at the
    6-PRB band edge with transition margin)."""
    if decim == 1:
        return np.array([1.0], np.float32)
    cutoff = 0.45 / decim
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(2 * cutoff * n) * np.hamming(ntaps)
    return (h / h.sum()).astype(np.float32)


def decimate(samples: jnp.ndarray, decim: int) -> jnp.ndarray:
    """FIR low-pass + downsample (complex-safe, conv as correlation)."""
    if decim == 1:
        return samples
    taps = jnp.asarray(_lpf_taps(decim))
    k = len(taps)

    def filt(x):
        xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(k // 2, k - 1 - k // 2)])
        win = jnp.stack([xp[..., i : i + x.shape[-1]] for i in range(k)], axis=-1)
        return jnp.matmul(win, taps, precision=jax.lax.Precision.HIGHEST)

    out = jax.lax.complex(filt(jnp.real(samples)), filt(jnp.imag(samples)))
    return out[..., ::decim]
