"""Rate matching / dematching — 36.212 §5.1.4 (turbo §5.1.4.1, conv §5.1.4.2).

The reference reaches this inside ``srslte_pdsch_decode_rnti`` /
``srslte_pdcch_*`` (SURVEY.md §2.1). Design: all interleaving and
circular-buffer selection is reduced to **host-precomputed index maps**
(cached per static (K, E, rv) bucket). On device:

* matching  = one gather            out[e]  = w[idx[e]]
* dematching = one scatter-add      w[idx[e]] += llr[e]   (HARQ soft-combine
  across retransmissions is then just `+` of w buffers, mirroring
  softbuffer semantics of ue/src/mac/dl_harq.cc:164-171).

NULL (dummy/filler) positions never appear in idx, so no masking is needed
on the hot path.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

C_SB = 32  # sub-block interleaver columns

# 36.212 Table 5.1.4-1 (turbo) inter-column permutation
PERM_TURBO = np.array(
    [0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
     1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
    dtype=np.int64,
)
# 36.212 Table 5.1.4-2 (convolutional) inter-column permutation
PERM_CONV = np.array(
    [1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
     0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30],
    dtype=np.int64,
)

NULL = -1  # marker inside index computations


def _subblock_rows(d: int) -> tuple[int, int]:
    r = int(np.ceil(d / C_SB))
    nd = r * C_SB - d
    return r, nd


def _interleave_idx(d: int, perm: np.ndarray) -> np.ndarray:
    """Indices into the ORIGINAL stream (length d) for the interleaved
    output of length R*32; NULL (=-1) where dummy padding sits."""
    r, nd = _subblock_rows(d)
    y = np.full(r * C_SB, NULL, dtype=np.int64)
    y[nd:] = np.arange(d)
    mat = y.reshape(r, C_SB)
    out = mat[:, perm].T.reshape(-1)  # read column-by-column
    return out


def _interleave_idx_d2(d: int) -> np.ndarray:
    """Third turbo stream: pi(k) = (P(floor(k/R)) + 32*(k mod R) + 1) mod Kp."""
    r, nd = _subblock_rows(d)
    kp = r * C_SB
    y = np.full(kp, NULL, dtype=np.int64)
    y[nd:] = np.arange(d)
    k = np.arange(kp)
    pi = (PERM_TURBO[k // r] + C_SB * (k % r) + 1) % kp
    return y[pi]


@functools.lru_cache(maxsize=512)
def turbo_w_indices(k_stream: int, n_filler: int = 0) -> np.ndarray:
    """Circular-buffer layout for turbo: w[3*Kp] holds indices into the
    3 concatenated d-streams (each length k_stream = K+4), NULL where dummy.

    d-streams are addressed flat: stream j element i -> j*k_stream + i.
    Filler <NULL> bits (36.212 §5.1.3.2.2) occupy d0[0:F] and d1[0:F] and
    are never transmitted; d2 filler-position parity IS transmitted.
    """
    base = _interleave_idx(k_stream, PERM_TURBO)
    filler = (base >= 0) & (base < n_filler)
    v0 = np.where(filler, NULL, base)
    v1 = np.where((base == NULL) | filler, NULL, base + k_stream)
    v2 = _interleave_idx_d2(k_stream)
    v2 = np.where(v2 == NULL, NULL, v2 + 2 * k_stream)
    kp = len(v0)
    w = np.empty(3 * kp, dtype=np.int64)
    w[:kp] = v0
    w[kp::2] = v1
    w[kp + 1 :: 2] = v2
    return w


def turbo_k0(k_stream: int, rv: int, n_cb: int | None = None) -> int:
    r, _ = _subblock_rows(k_stream)
    kp = r * C_SB
    ncb = 3 * kp if n_cb is None else n_cb
    return r * (2 * int(np.ceil(ncb / (8 * r))) * rv + 2)


@functools.lru_cache(maxsize=4096)
def turbo_rm_indices(
    k_stream: int, e: int, rv: int, n_cb: int | None = None, n_filler: int = 0
) -> np.ndarray:
    """Index map for turbo rate matching: out[e] = d_flat[idx[e]] where
    d_flat is the [3*k_stream] concatenated stream array. Skips NULLs
    (both interleaver dummies and segmentation fillers).
    Also used transposed for dematching via scatter-add."""
    w = turbo_w_indices(k_stream, n_filler)
    ncb = len(w) if n_cb is None else n_cb
    w = w[:ncb]
    k0 = turbo_k0(k_stream, rv, None if n_cb is None else ncb)
    # walk the circular buffer from k0 skipping NULLs until e bits emitted
    rolled = np.roll(w, -(k0 % len(w)))
    vals = rolled[rolled != NULL]
    reps = -(-e // len(vals))
    return np.tile(vals, reps)[:e]


@functools.lru_cache(maxsize=512)
def conv_rm_indices(k_stream: int, e: int) -> np.ndarray:
    """Convolutional rate matching (PBCH/PDCCH/CFI...): w = [v0 v1 v2] each
    sub-block interleaved with PERM_CONV; selection from k0=0, skip NULLs."""
    vs = []
    for j in range(3):
        v = _interleave_idx(k_stream, PERM_CONV)
        v = np.where(v == NULL, NULL, v + j * k_stream)
        vs.append(v)
    w = np.concatenate(vs)
    vals = w[w != NULL]
    reps = -(-e // len(vals))
    return np.tile(vals, reps)[:e]


# ---------------------------------------------------------------------------
# Device-side (de)matching
# ---------------------------------------------------------------------------


def match(d_flat: jnp.ndarray, idx: np.ndarray) -> jnp.ndarray:
    """[..., 3*k_stream] -> [..., E] gather (TX side)."""
    return d_flat[..., jnp.asarray(idx)]


def dematch(llrs: jnp.ndarray, idx: np.ndarray, d_len: int) -> jnp.ndarray:
    """[..., E] LLRs -> [..., d_len] via scatter-add (RX side). Positions
    transmitted multiple times accumulate; untransmitted positions are 0."""
    out = jnp.zeros(llrs.shape[:-1] + (d_len,), dtype=llrs.dtype)
    return out.at[..., jnp.asarray(idx)].add(llrs)
