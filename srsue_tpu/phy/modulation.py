"""Constellation mapping and max-log soft demapping (36.211 §7.1).

Design notes
------------
* The mapper is a gather from a constant constellation table — XLA turns
  this into a vectorized table lookup; the bit->symbol-index packing is a
  small matmul against powers of two.
* The demapper is **exact max-log**: per bit, LLR = (min_{s: b=1}|y-s|^2 -
  min_{s: b=0}|y-s|^2) / sigma^2, computed by broadcasting against the 2/4/8
  PAM levels per axis (Gray mapping makes I and Q separable). This stays
  fully element-wise with a tiny constant table — no per-symbol
  control flow, so it fuses into the equalizer output.

Reference parity target: srsLTE soft demapper consumed by
``srslte_pdsch_decode_rnti`` (ue/src/phy/phch_worker.cc:347).
LLR sign convention: positive LLR == bit 0 more likely (matches the
descrambler using +1/-1 sequence multiply).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from .cell import MOD_16QAM, MOD_64QAM, MOD_BPSK, MOD_QPSK

# PAM amplitude levels indexed by the magnitude-bits value (Gray order per
# 36.211 tables: 16QAM level bits b2 -> {1,3}; 64QAM bits b2b4 -> {3,1,5,7}).
_A16 = 1.0 / np.sqrt(10.0)
_A64 = 1.0 / np.sqrt(42.0)
_A2 = 1.0 / np.sqrt(2.0)


@functools.lru_cache(maxsize=8)
def constellation(mod_order: int) -> np.ndarray:
    """Complex64 table of size 2**mod_order indexed by the bit word
    (b0 b1 ... b_{Qm-1}, b0 = MSB)."""
    m = mod_order
    words = np.arange(1 << m)
    bits = (words[:, None] >> np.arange(m - 1, -1, -1)[None, :]) & 1
    if m == MOD_BPSK:
        sym = (1 - 2 * bits[:, 0]) * (_A2 + 1j * _A2)
    elif m == MOD_QPSK:
        sym = _A2 * ((1 - 2 * bits[:, 0]) + 1j * (1 - 2 * bits[:, 1]))
    elif m == MOD_16QAM:
        i = (1 - 2 * bits[:, 0]) * (2 - (1 - 2 * bits[:, 2]))
        q = (1 - 2 * bits[:, 1]) * (2 - (1 - 2 * bits[:, 3]))
        sym = _A16 * (i + 1j * q)
    elif m == MOD_64QAM:
        i = (1 - 2 * bits[:, 0]) * (4 - (1 - 2 * bits[:, 2]) * (2 - (1 - 2 * bits[:, 4])))
        q = (1 - 2 * bits[:, 1]) * (4 - (1 - 2 * bits[:, 3]) * (2 - (1 - 2 * bits[:, 5])))
        sym = _A64 * (i + 1j * q)
    else:
        raise ValueError(f"unsupported mod_order={m}")
    return sym.astype(np.complex64)


def modulate_np(bits: np.ndarray, mod_order: int) -> np.ndarray:
    """Host-numpy mapper twin (eNB-side test-vector generation)."""
    m = mod_order
    tab = constellation(m)
    b = np.asarray(bits, dtype=np.int64).reshape(bits.shape[:-1] + (-1, m))
    pw = (1 << np.arange(m - 1, -1, -1)).astype(np.int64)
    return tab[(b * pw).sum(-1)]


def modulate(bits: jnp.ndarray, mod_order: int) -> jnp.ndarray:
    """[..., n*Qm] {0,1} bits -> [..., n] complex symbols."""
    m = mod_order
    tab = jnp.asarray(constellation(m))
    b = bits.reshape(bits.shape[:-1] + (-1, m)).astype(jnp.int32)
    pw = jnp.asarray(1 << np.arange(m - 1, -1, -1), dtype=jnp.int32)
    idx = jnp.sum(b * pw, axis=-1)
    return tab[idx]


@functools.lru_cache(maxsize=8)
def _pam_levels(mod_order: int) -> tuple[np.ndarray, np.ndarray]:
    """(levels[L], bits[L, nbits_per_axis]) for the per-axis PAM decomposition.
    Axis bits in transmit order (sign bit first, then magnitude bits)."""
    if mod_order == MOD_QPSK:
        lv = np.array([_A2, -_A2])
        bt = np.array([[0], [1]])
    elif mod_order == MOD_16QAM:
        signs = np.array([1, -1])
        mags = np.array([1, 3])
        lv, bt = [], []
        for sb, s in enumerate(signs):
            for mb, g in enumerate(mags):
                lv.append(_A16 * s * g)
                bt.append([sb, mb])
        lv, bt = np.array(lv), np.array(bt)
    elif mod_order == MOD_64QAM:
        lv, bt = [], []
        for sb, s in enumerate([1, -1]):
            for b2 in range(2):
                for b4 in range(2):
                    g = 4 - (1 - 2 * b2) * (2 - (1 - 2 * b4))
                    lv.append(_A64 * s * g)
                    bt.append([sb, b2, b4])
        lv, bt = np.array(lv), np.array(bt)
    else:
        raise ValueError(f"unsupported mod_order={mod_order}")
    return lv.astype(np.float32), bt.astype(np.int32)


def demodulate_soft(
    sym: jnp.ndarray, mod_order: int, noise_var: jnp.ndarray | float = 1.0
) -> jnp.ndarray:
    """Exact max-log LLRs. [..., n] complex -> [..., n*Qm] float.

    LLR > 0 favors bit 0. `noise_var` broadcasts against the symbol shape
    (per-RE post-equalization noise variance from the MMSE equalizer).
    """
    m = mod_order
    lv, bt = _pam_levels(m)
    lv_j = jnp.asarray(lv)  # [L]
    nax = bt.shape[1]

    def axis_llrs(x):
        # x: [...] real part or imag part; distances to each PAM level
        d2 = (x[..., None] - lv_j) ** 2  # [..., L]
        outs = []
        for bi in range(nax):
            mask1 = jnp.asarray(bt[:, bi] == 1)
            big = jnp.float32(1e30)
            m1 = jnp.min(jnp.where(mask1, d2, big), axis=-1)
            m0 = jnp.min(jnp.where(mask1, big, d2), axis=-1)
            outs.append(m1 - m0)
        return outs  # list of [...] per axis bit

    i_llr = axis_llrs(jnp.real(sym))
    q_llr = axis_llrs(jnp.imag(sym))
    # interleave transmit bit order: b0(I sign), b1(Q sign), b2(I mag), ...
    per_bit = []
    for k in range(nax):
        per_bit.append(i_llr[k])
        per_bit.append(q_llr[k])
    llr = jnp.stack(per_bit, axis=-1)  # [..., n, Qm]
    nv = jnp.asarray(noise_var, dtype=llr.dtype)
    llr = llr / jnp.maximum(nv[..., None] if nv.ndim else nv, 1e-9)
    return llr.reshape(sym.shape[:-1] + (-1,))


def demodulate_hard(sym: jnp.ndarray, mod_order: int) -> jnp.ndarray:
    """Hard decisions via sign of max-log LLRs (bit = 1 when LLR < 0)."""
    return (demodulate_soft(sym, mod_order) < 0).astype(jnp.uint8)
