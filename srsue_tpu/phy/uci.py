"""UCI coding — CQI block code RM(20, A) (36.212 §5.2.3.3) + PUCCH
format 2 carrier (36.211 §5.4.2).

The (20, A<=13) Reed-Muller-style code from 36.212 Table 5.2.3.3-1.
Decoding is a batched correlation against all 2^A codewords (A<=11 in
practice for CQI) — one matmul, the batched ML decode.
"""

from __future__ import annotations

import functools

import numpy as np

from . import modulation, seq as seqmod
from .cell import Cell
from .pucch import base_seq12, _cyclic_shift_per_symbol

# 36.212 Table 5.2.3.3-1: basis sequences M_{i,n}, i=0..19, n=0..12
RM20_BASIS = np.array([
    [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0],
    [1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0],
    [1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 1],
    [1, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 1, 1],
    [1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1],
    [1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1],
    [1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1],
    [1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 1],
    [1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1],
    [1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 1, 1, 1],
    [1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1, 1],
    [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1, 1],
    [1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1],
    [1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1, 0, 1],
    [1, 1, 1, 0, 1, 1, 1, 0, 0, 1, 0, 1, 1],
    [1, 0, 0, 1, 1, 1, 0, 0, 1, 0, 0, 1, 1],
    [1, 1, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
    [1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0],
], dtype=np.uint8)


def rm20_encode(bits: np.ndarray) -> np.ndarray:
    """[A<=13] info bits -> [20] codeword."""
    a = np.asarray(bits, np.uint8).ravel()
    assert len(a) <= 13
    return (RM20_BASIS[:, : len(a)] @ a % 2).astype(np.uint8)


@functools.lru_cache(maxsize=16)
def _codebook(n_bits: int) -> np.ndarray:
    """[2^A, 20] +-1 codebook for ML correlation decoding."""
    words = np.arange(1 << n_bits)
    bits = (words[:, None] >> np.arange(n_bits)[None, :]) & 1
    cws = (bits @ RM20_BASIS[:, :n_bits].T) % 2
    return (1.0 - 2.0 * cws).astype(np.float32)


def rm20_decode(llrs: np.ndarray, n_bits: int) -> tuple[np.ndarray, float]:
    """ML decode via correlation with all 2^A codewords (positive LLR =
    bit 0 convention -> +1)."""
    cb = _codebook(n_bits)
    scores = cb @ np.asarray(llrs, np.float32)
    w = int(np.argmax(scores))
    bits = (w >> np.arange(n_bits)) & 1
    return bits.astype(np.uint8), float(scores[w])


# ---------------------------------------------------------------------------
# PUCCH format 2: 20 coded bits -> QPSK -> 10 cyclically-shifted sequences
# ---------------------------------------------------------------------------

F2_DATA_SYMS = (0, 2, 3, 4, 6)  # per slot, normal CP (RS at 1, 5)
F2_RS_SYMS = (1, 5)


def encode_format2(cell: Cell, subframe: int, n_pucch: int,
                   cqi_bits: np.ndarray) -> np.ndarray:
    """CQI payload -> [n_sym_sf, n_sc] grid contribution (zeros elsewhere).
    Scrambled with c_init = (ns+1)(2cellid+1)*2^9? — format 2 uses the
    PUSCH-style scrambling c_init = n_rnti*2^14 + ... ; for the cell-level
    loop here we scramble with the cell/slot Gold sequence."""
    cw = rm20_encode(cqi_bits)
    c = seqmod.prs(((subframe + 1) * (2 * cell.cell_id + 1) << 9)
                   + cell.cell_id, 20)
    d = modulation.modulate_np(cw ^ c, 2)  # 10 QPSK symbols
    grid = np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)
    r = base_seq12(cell.cell_id)
    m = n_pucch % 12  # resource index -> cyclic shift offset (simplified)
    from .pucch import pucch_prb

    di = 0
    for slot in range(2):
        prb = pucch_prb(cell, n_pucch, slot)
        sc0 = prb * 12
        for l in F2_DATA_SYMS:
            ns = 2 * subframe + slot
            alpha = _cyclic_shift_per_symbol(cell, ns, l, m)
            y = d[di] * r * np.exp(1j * alpha * np.arange(12))
            grid[slot * cell.n_sym_slot + l, sc0 : sc0 + 12] = y / np.sqrt(12)
            di += 1
        for l in F2_RS_SYMS:
            ns = 2 * subframe + slot
            alpha = _cyclic_shift_per_symbol(cell, ns, l, m)
            grid[slot * cell.n_sym_slot + l, sc0 : sc0 + 12] = (
                r * np.exp(1j * alpha * np.arange(12)) / np.sqrt(12)
            )
    return grid


def decode_format2(cell: Cell, grid: np.ndarray, subframe: int, n_pucch: int,
                   n_bits: int) -> tuple[np.ndarray, float]:
    """eNB-side: coherent demod (RS channel estimate) + RM(20,A) ML."""
    from .pucch import pucch_prb

    r = base_seq12(cell.cell_id)
    m = n_pucch % 12
    llr = np.zeros(20, np.float32)
    di = 0
    soft = np.zeros(10, np.complex64)
    for slot in range(2):
        prb = pucch_prb(cell, n_pucch, slot)
        sc0 = prb * 12
        h = 0j
        for l in F2_RS_SYMS:
            ns = 2 * subframe + slot
            alpha = _cyclic_shift_per_symbol(cell, ns, l, m)
            ref = r * np.exp(1j * alpha * np.arange(12))
            h += np.vdot(ref, grid[slot * cell.n_sym_slot + l, sc0 : sc0 + 12])
        for l in F2_DATA_SYMS:
            ns = 2 * subframe + slot
            alpha = _cyclic_shift_per_symbol(cell, ns, l, m)
            ref = r * np.exp(1j * alpha * np.arange(12))
            corr = np.vdot(ref, grid[slot * cell.n_sym_slot + l, sc0 : sc0 + 12])
            soft[di] = corr * np.conj(h)
            di += 1
    # QPSK -> LLRs (positive = bit 0), then descramble
    llr[0::2] = np.real(soft) * np.sqrt(2)
    llr[1::2] = np.imag(soft) * np.sqrt(2)
    c = seqmod.prs(((subframe + 1) * (2 * cell.cell_id + 1) << 9)
                   + cell.cell_id, 20)
    llr = llr * (1.0 - 2.0 * c)
    return rm20_decode(llr, n_bits)
