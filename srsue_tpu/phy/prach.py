"""PRACH — Zadoff-Chu preamble generation + eNB-side detection
(36.211 §5.7; reference: ue/src/phy/prach.cc — pregenerates all 64
preambles at cell init, CFO-corrects and scales at send time).

Format 0 (the FDD default): N_zc = 839, 1.25 kHz subcarrier spacing,
T_cp = 3168 Ts, T_seq = 24576 Ts (Ts = 1/30.72 MHz), occupying 6 PRB.

Design: preambles are host-precomputed frequency-domain ZC roots
(config-time, mirroring prach.cc:88-97); the time-domain waveform is one
zero-padded IFFT at the cell's sample rate; detection is a batched
matched filter over all 64 preambles — one matmul [n_fft_prach] x
[839, 64] in the PRACH frequency grid.
"""

from __future__ import annotations

import functools

import numpy as np

from .cell import Cell

NZC = 839
# 36.211 Table 5.7.2-2: N_cs values for zeroCorrelationZoneConfig (format 0,
# unrestricted set)
NCS_TABLE = [0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119, 167, 279, 419]

T_SEQ = 24576  # in Ts units (30.72 Msps)
T_CP = 3168


@functools.lru_cache(maxsize=64)
def root_sequence(u: int) -> np.ndarray:
    n = np.arange(NZC)
    return np.exp(-1j * np.pi * u * n * (n + 1) / NZC).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def preamble_table(root_seq_index: int, zero_corr_config: int) -> np.ndarray:
    """[64, 839] frequency-domain preambles x_{u,v} (36.211 §5.7.2 logical
    ordering: cyclic shifts of a root first, then successive roots)."""
    # logical -> physical root order: sequential from the configured index
    ncs = NCS_TABLE[zero_corr_config]
    out = np.zeros((64, NZC), np.complex64)
    count = 0
    logical = root_seq_index
    while count < 64:
        u = _logical_to_physical(logical)
        x_u = root_sequence(u)
        n_shifts = max(1, NZC // ncs) if ncs else 1
        for v in range(n_shifts):
            if count >= 64:
                break
            cv = v * ncs
            out[count] = np.roll(x_u, -cv)
            count += 1
        logical += 1
    return out


@functools.lru_cache(maxsize=1)
def _logical_table() -> list[int]:
    """36.211 Table 5.7.2-4 logical root order; the standard's table is a
    specific sequence — we use the u/(839-u) pairing order which matches
    its structure (each logical pair (u, NZC-u))."""
    order = []
    seen = set()
    for u in range(1, NZC):
        if u in seen:
            continue
        order.append(u)
        order.append(NZC - u)
        seen.add(u)
        seen.add(NZC - u)
    return order


def _logical_to_physical(logical: int) -> int:
    return _logical_table()[logical % (NZC - 1)]


@functools.lru_cache(maxsize=32)
def waveform(cell: Cell, root_seq_index: int, zero_corr: int, preamble_idx: int,
             freq_offset: int = 0) -> np.ndarray:
    """Time-domain PRACH at the cell sample rate: [T_cp + T_seq scaled]."""
    scale = cell.srate / 30.72e6
    n_seq = int(T_SEQ * scale)
    n_cp = int(T_CP * scale)
    xf = np.fft.fft(preamble_table(root_seq_index, zero_corr)[preamble_idx])
    # place 839 1.25kHz bins: PRACH spans 6 PRB = 1.08 MHz; center them on
    # the PRB offset region. Subcarrier k of PRACH at 1.25 kHz spacing:
    # use an n_seq-point IFFT where bin spacing = srate/n_seq = 1.25 kHz.
    assert abs(cell.srate / n_seq - 1250.0) < 1e-6
    fd = np.zeros(n_seq, np.complex64)
    # frequency start: freq_offset PRBs from band edge -> in 1.25kHz bins
    k0 = int((freq_offset * 12 - cell.n_sc // 2) * 15000 / 1250) + 7
    bins = (np.arange(NZC) + k0) % n_seq
    fd[bins] = xf
    td = np.fft.ifft(fd) * np.sqrt(n_seq / NZC)
    return np.concatenate([td[-n_cp:], td]).astype(np.complex64)


def detect(cell: Cell, rx: np.ndarray, root_seq_index: int, zero_corr: int,
           freq_offset: int = 0, threshold: float = 8.0):
    """eNB-side batched matched filter: returns list of (preamble_idx,
    peak_metric, timing_offset_samples)."""
    scale = cell.srate / 30.72e6
    n_seq = int(T_SEQ * scale)
    n_cp = int(T_CP * scale)
    seg = rx[n_cp : n_cp + n_seq]
    fd = np.fft.fft(seg)
    k0 = int((freq_offset * 12 - cell.n_sc // 2) * 15000 / 1250) + 7
    bins = (np.arange(NZC) + k0) % n_seq
    y = fd[bins]  # [839]
    table = preamble_table(root_seq_index, zero_corr)
    xf = np.fft.fft(table, axis=-1)  # [64, 839]
    corr_f = y[None, :] * np.conj(xf)
    corr_t = np.fft.ifft(corr_f, axis=-1)  # [64, 839] circular correlation
    power = np.abs(corr_t) ** 2
    noise = np.mean(power) + 1e-12
    hits = []
    ncs = NCS_TABLE[zero_corr] or NZC
    for p in range(64):
        pk = power[p].max() / noise
        lag = int(np.argmax(power[p]))
        if pk > threshold and (lag < ncs or lag > NZC - 3):
            hits.append((p, float(pk), lag))
    return hits
