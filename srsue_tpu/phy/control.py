"""Control region — PCFICH, PHICH, PDCCH REG/CCE geometry, encode/decode
(36.211 §6.7/6.8/6.9, 36.212 §5.1.4.2/5.3.3, 36.213 §9.1.1).

Capability parity with srsLTE ``srslte_pdcch_extract_llr`` + blind DCI
search + ``decode_phich`` + CFI decode (ue/src/phy/phch_worker.cc:246-477).

Design: the REG/CCE geometry (including the quadruplet sub-block
interleaver and cell-ID cyclic shift) is folded into host-precomputed
per-CCE RE index tables; the device sees only:

* PCFICH: one [32] x [32, 3] correlation matmul -> argmax CFI,
* PHICH: a length-12 despread (dot with the orthogonal sequence),
* PDCCH blind search: ALL (candidate, format-size) hypotheses gathered
  into one batch and decoded by ONE batched Viterbi call (SURVEY.md §7
  hard part 2: data-dependent blind search -> fixed hypothesis batch).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import convcode, crc, modulation, ratematch, seq
from .cell import Cell
from .ratematch import PERM_CONV
from ..utils.jaxutil import cgather

# ---------------------------------------------------------------------------
# REG geometry
# ---------------------------------------------------------------------------


def _crs_k_mod6(cell: Cell) -> tuple[int, int]:
    return (cell.vshift % 6, (3 + cell.vshift) % 6)


@functools.lru_cache(maxsize=128)
def regs_in_symbol(cell: Cell, l: int) -> tuple[tuple[int, ...], ...]:
    """REGs of symbol l as tuples of 4 flat RE indices (sym*n_sc + k),
    ordered by frequency."""
    n_sc = cell.n_sc
    regs = []
    crs_in_sym = l == 0 or (l == 1 and cell.n_ports == 4)
    if crs_in_sym:
        a, b = _crs_k_mod6(cell)
        if l == 1:  # ports 2/3 CRS shifts
            a, b = (cell.vshift % 6, (3 + cell.vshift) % 6)
        for m in range(n_sc // 6):
            ks = [6 * m + j for j in range(6) if j % 6 not in (a % 6, b % 6)]
            # exactly 4 non-CRS REs per 6 subcarriers
            ks = [6 * m + j for j in range(6) if (j % 3) != (a % 3)]
            regs.append(tuple(l * n_sc + k for k in ks))
    else:
        for m in range(n_sc // 4):
            regs.append(tuple(l * n_sc + 4 * m + j for j in range(4)))
    return tuple(regs)


@functools.lru_cache(maxsize=128)
def pcfich_regs(cell: Cell) -> tuple[int, ...]:
    """Indices (into regs_in_symbol(cell, 0)) of the 4 PCFICH REGs."""
    n_rb = cell.n_prb
    k_bar = 6 * (cell.cell_id % (2 * n_rb))
    out = []
    for z in range(4):
        k = (k_bar + (z * n_rb // 2) * 6) % cell.n_sc
        out.append(k // 6)
    return tuple(out)


def n_phich_groups(cell: Cell) -> int:
    import math

    return max(1, math.ceil(cell.phich_resources * cell.n_prb / 8))


@functools.lru_cache(maxsize=128)
def phich_reg_table(cell: Cell) -> tuple[tuple[int, ...], ...]:
    """Per PHICH group: indices into regs_in_symbol(cell, 0) of its 3 REGs
    (normal duration: all in symbol 0). 36.211 §6.9.3."""
    avail = [i for i in range(len(regs_in_symbol(cell, 0))) if i not in pcfich_regs(cell)]
    n0 = len(avail)
    out = []
    for m in range(n_phich_groups(cell)):
        regs = []
        for i in range(3):
            n_i = (cell.cell_id + m + (i * n0) // 3) % n0
            regs.append(avail[n_i])
        out.append(tuple(regs))
    return tuple(out)


@functools.lru_cache(maxsize=256)
def pdcch_geometry(cell: Cell, cfi: int):
    """(n_cce, cce_re_idx [n_cce, 36]) — flat RE indices of each CCE after
    quadruplet interleaving + cell-ID cyclic shift (36.211 §6.8.5)."""
    used0 = set()
    for r in pcfich_regs(cell):
        used0.add(r)
    for grp in phich_reg_table(cell):
        used0.update(grp)

    # REG list in (k, l) order over the control region (cfi+1 symbols for
    # narrow cells, 36.211 §6.7)
    from . import regrid

    reg_list: list[tuple[int, tuple[int, ...]]] = []  # (sort key k, REs)
    per_sym = []
    for l in range(regrid.control_span(cell, cfi)):
        regs = regs_in_symbol(cell, l)
        for i, res in enumerate(regs):
            if l == 0 and i in used0:
                continue
            k0 = res[0] % cell.n_sc
            reg_list.append(((k0, l), res))
        per_sym.append(regs)
    reg_list.sort(key=lambda t: t[0])
    regs_ordered = [res for _, res in reg_list]
    n_reg = len(regs_ordered)
    n_cce = n_reg // 9

    # quadruplet sub-block interleaver (conv permutation on indices)
    perm = ratematch._interleave_idx(n_reg, PERM_CONV)
    perm = perm[perm >= 0]  # drop dummies -> permutation of 0..n_reg-1
    # REG position i carries interleaved-quadruplet w[perm[(i+cellid)%n]]
    reg_of_w = np.empty(n_reg, dtype=np.int64)
    for i in range(n_reg):
        reg_of_w[perm[(i + cell.cell_id) % n_reg]] = i

    cce_re = np.zeros((n_cce, 36), dtype=np.int32)
    for c in range(n_cce):
        res = []
        for j in range(9):
            w_idx = 9 * c + j
            res.extend(regs_ordered[reg_of_w[w_idx]])
        cce_re[c] = res
    return n_cce, cce_re


# ---------------------------------------------------------------------------
# PCFICH
# ---------------------------------------------------------------------------

_CFI_CW = np.array(
    [
        [0, 1, 1] * 10 + [0, 1],
        [1, 0, 1] * 10 + [1, 0],
        [1, 1, 0] * 10 + [1, 1],
    ],
    dtype=np.uint8,
)  # 36.212 Table 5.3.4-1 (periodic 011/101/110 patterns, 32 bits)


def _cfi_scramble(cell: Cell, subframe: int) -> np.ndarray:
    c_init = ((subframe + 1) * (2 * cell.cell_id + 1) << 9) + cell.cell_id
    return seq.prs(c_init, 32)


@functools.lru_cache(maxsize=256)
def _pcfich_re(cell: Cell) -> np.ndarray:
    regs = regs_in_symbol(cell, 0)
    idx = []
    for r in pcfich_regs(cell):
        idx.extend(regs[r])
    return np.asarray(idx, dtype=np.int32)


def pcfich_encode(cell: Cell, subframe: int, cfi: int) -> np.ndarray:
    bits = _CFI_CW[cfi - 1] ^ _cfi_scramble(cell, subframe)
    return modulation.modulate_np(bits, 2)  # 16 QPSK symbols


def pcfich_map(cell: Cell, grid: np.ndarray, subframe: int, cfi: int) -> None:
    grid.reshape(-1)[_pcfich_re(cell)] = pcfich_encode(cell, subframe, cfi)


def _gather_re(grid_eq: jnp.ndarray, nv_eff, idx: np.ndarray):
    """Pull (symbols, per-RE noise) for a flat RE index list from an
    equalized [..., n_sym, n_sc] grid; nv_eff may be grid-shaped or
    scalar/batch-shaped."""
    flat = grid_eq.reshape(grid_eq.shape[:-2] + (-1,))
    y = cgather(flat, jnp.asarray(idx), axis=-1)
    nv = jnp.asarray(nv_eff)
    if nv.ndim >= 2 and nv.shape[-2:] == grid_eq.shape[-2:]:
        nv = jnp.take(nv.reshape(nv.shape[:-2] + (-1,)), jnp.asarray(idx), axis=-1)
    return y, nv


def pcfich_decode(cell: Cell, grid_eq: jnp.ndarray, nv_eff, subframe: int):
    """Equalized grid -> (cfi, correlation scores[3]). One matmul."""
    y, nv = _gather_re(grid_eq, nv_eff, _pcfich_re(cell))  # [..., 16]
    llr = modulation.demodulate_soft(y, 2, nv)  # [..., 32]
    s = jnp.asarray((1.0 - 2.0 * _cfi_scramble(cell, subframe)).astype(np.float32))
    cw = jnp.asarray((1.0 - 2.0 * _CFI_CW).astype(np.float32))  # [3, 32]
    scores = jnp.matmul(llr * s, cw.T, precision=jax.lax.Precision.HIGHEST)  # [..., 3]
    return jnp.argmax(scores, axis=-1) + 1, scores


# ---------------------------------------------------------------------------
# PHICH
# ---------------------------------------------------------------------------

_PHICH_W = np.array(
    [
        [1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1],
    ],
    dtype=np.float32,
)  # real part; sequences 4..7 are j * w (36.211 Table 6.9.1-2)


@functools.lru_cache(maxsize=256)
def _phich_re(cell: Cell, group: int) -> np.ndarray:
    regs = regs_in_symbol(cell, 0)
    idx = []
    for r in phich_reg_table(cell)[group]:
        idx.extend(regs[r])
    return np.asarray(idx, dtype=np.int32)


def phich_symbols(cell: Cell, subframe: int, group: int, nseq: int, ack: bool) -> np.ndarray:
    """The 12 complex symbols of one PHICH (BPSK*orthogonal, scrambled)."""
    c_init = ((subframe + 1) * (2 * cell.cell_id + 1) << 9) + cell.cell_id
    c = 1.0 - 2.0 * seq.prs(c_init, 12).astype(np.float32)
    b = 0 if ack else 1
    z = (1.0 - 2.0 * b) / np.sqrt(2) * (1 + 1j)  # BPSK on the diagonal
    w = _PHICH_W[nseq % 4] * (1j if nseq >= 4 else 1.0)
    d = np.tile(w, 3) * z * c
    return d.astype(np.complex64)


def phich_map(cell: Cell, grid: np.ndarray, subframe: int, group: int, nseq: int, ack: bool) -> None:
    flat = grid.reshape(-1)
    flat[_phich_re(cell, group)] += phich_symbols(cell, subframe, group, nseq, ack)


def phich_decode(cell: Cell, grid_eq: jnp.ndarray, subframe: int, group: int, nseq: int):
    """Equalized grid -> soft ACK metric (positive = ACK). Despread."""
    flat = grid_eq.reshape(grid_eq.shape[:-2] + (-1,))
    y = cgather(flat, jnp.asarray(_phich_re(cell, group)), axis=-1)  # [..., 12]
    ref = phich_symbols(cell, subframe, group, nseq, ack=True)
    m = jnp.real(jnp.matmul(y, jnp.conj(jnp.asarray(ref)), precision=jax.lax.Precision.HIGHEST))
    return m  # > 0 -> ACK


# ---------------------------------------------------------------------------
# Transmit diversity (2-port SFBC, 36.211 §6.3.4.3) for the control region.
# Every control channel maps in REG quadruplets whose 4 REs stay adjacent
# in mapping order, so SFBC pairs are (0,1) and (2,3) of each quadruplet —
# one precode/combine convention serves PCFICH, PHICH and PDCCH alike.
# ---------------------------------------------------------------------------


def _sfbc_precode(sym: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pairwise SFBC: port0 (x0, x1)/sqrt2, port1 (-x1*, x0*)/sqrt2 —
    the convention equalize.alamouti_combine inverts."""
    x0, x1 = sym[0::2], sym[1::2]
    s = 1.0 / np.sqrt(2.0)
    p0 = np.stack([x0, x1], axis=-1).reshape(sym.shape) * s
    p1 = np.stack([-np.conj(x1), np.conj(x0)],
                  axis=-1).reshape(sym.shape) * s
    return p0.astype(np.complex64), p1.astype(np.complex64)


def pcfich_map_tm2(cell: Cell, grids, subframe: int, cfi: int) -> None:
    p0, p1 = _sfbc_precode(pcfich_encode(cell, subframe, cfi))
    idx = _pcfich_re(cell)
    grids[0].reshape(-1)[idx] = p0
    grids[1].reshape(-1)[idx] = p1


def phich_map_tm2(cell: Cell, grids, subframe: int, group: int, nseq: int,
                  ack: bool) -> None:
    p0, p1 = _sfbc_precode(phich_symbols(cell, subframe, group, nseq, ack))
    idx = _phich_re(cell, group)
    grids[0].reshape(-1)[idx] += p0
    grids[1].reshape(-1)[idx] += p1


def pdcch_map_tm2(cell: Cell, grids, subframe: int, cfi: int,
                  dci_bits: np.ndarray, rnti: int, n_cce: int,
                  l_aggr: int) -> None:
    _, cce_re = pdcch_geometry(cell, cfi)
    bits = pdcch_encode(cell, subframe, dci_bits, rnti, l_aggr)
    n_cce_tot, _ = pdcch_geometry(cell, cfi)
    scr_full = _pdcch_scramble(cell, subframe, 72 * n_cce_tot)
    scr = scr_full[72 * n_cce : 72 * n_cce + 72 * l_aggr]
    sym = modulation.modulate_np(bits ^ scr, 2)
    res = cce_re[n_cce : n_cce + l_aggr].reshape(-1)
    p0, p1 = _sfbc_precode(sym)
    grids[0].reshape(-1)[res] = p0
    grids[1].reshape(-1)[res] = p1


@functools.lru_cache(maxsize=64)
def _control_region_idx(cell: Cell, n_sym: int | None = None) -> np.ndarray:
    """Flat RE indices of every REG in the (max-size) control region, in
    quadruplet order. The max span is cell-dependent: narrow cells
    (n_prb <= 10) carry the control region over CFI+1 symbols (36.211
    Table 6.7-1), so their max is 4 symbols, not 3 (ADVICE r4)."""
    if n_sym is None:
        from . import regrid

        n_sym = regrid.control_span(cell, 3)
    idx = []
    for l in range(n_sym):
        for reg in regs_in_symbol(cell, l):
            idx.extend(reg)
    return np.asarray(idx, dtype=np.int64)


def sfbc_equalize_control(cell: Cell, grid: jnp.ndarray, h0, h1, nvar):
    """Raw grid + per-port channel estimates -> a pseudo-equalized grid
    whose CONTROL-REGION REs hold SFBC-combined symbol estimates (paired
    within each REG quadruplet), plus a matching per-RE noise grid
    (huge noise elsewhere, so stray REs demap to zero LLR). The
    single-port decoders (pcfich_decode / phich_decode / pdcch_blind_*)
    then run UNCHANGED on the combined grid — srslte's per-channel
    predecoding collapsed into one pass."""
    import jax

    from . import equalize

    idx_np = _control_region_idx(cell)
    idx = jnp.asarray(idx_np)

    def flat(g):
        return g.reshape(g.shape[:-2] + (-1,))

    y = cgather(flat(grid), idx, axis=-1)
    g0 = cgather(flat(h0), idx, axis=-1)
    g1 = cgather(flat(h1), idx, axis=-1)
    x, nv_eff = equalize.alamouti_combine(y, g0, g1, nvar)
    n = cell.n_sym_sf * cell.n_sc
    lead = grid.shape[:-2]
    zr = jnp.zeros(lead + (n,), jnp.float32).at[..., idx].set(
        jnp.real(x).astype(jnp.float32))
    zi = jnp.zeros(lead + (n,), jnp.float32).at[..., idx].set(
        jnp.imag(x).astype(jnp.float32))
    g_eq = jax.lax.complex(zr, zi).reshape(
        lead + (cell.n_sym_sf, cell.n_sc))
    nv_grid = jnp.full(lead + (n,), 1e6, jnp.float32).at[..., idx].set(
        nv_eff.astype(jnp.float32)).reshape(
        lead + (cell.n_sym_sf, cell.n_sc))
    return g_eq, nv_grid


def phich_group_seq(n_prb_lowest: int, dmrs_cshift: int, n_groups: int) -> tuple[int, int]:
    """(group, sequence) for a PUSCH allocation (36.213 §9.1.2)."""
    group = (n_prb_lowest + dmrs_cshift) % n_groups
    nseq = ((n_prb_lowest // n_groups) + dmrs_cshift) % 8
    return group, nseq


# ---------------------------------------------------------------------------
# PDCCH
# ---------------------------------------------------------------------------


def _pdcch_scramble(cell: Cell, subframe: int, n_bits: int) -> np.ndarray:
    c_init = (subframe << 9) + cell.cell_id
    return seq.prs(c_init, n_bits)


def pdcch_encode(cell: Cell, subframe: int, dci_bits: np.ndarray, rnti: int, l_aggr: int) -> np.ndarray:
    """DCI payload -> 36*L QPSK symbols (CRC16 masked by RNTI, tail-biting
    conv coding, rate matching to 72L, scrambled at its CCE offset)."""
    b = crc.attach(dci_bits, "16", mask=rnti)
    coded = convcode.encode(b)
    e = 72 * l_aggr
    idx = ratematch.conv_rm_indices(len(b), e)
    bits = coded.reshape(-1)[idx]
    return bits  # scrambling applied at map time (needs CCE offset)


def pdcch_map(
    cell: Cell, grid: np.ndarray, subframe: int, cfi: int,
    dci_bits: np.ndarray, rnti: int, n_cce: int, l_aggr: int,
) -> None:
    _, cce_re = pdcch_geometry(cell, cfi)
    bits = pdcch_encode(cell, subframe, dci_bits, rnti, l_aggr)
    n_cce_tot, _ = pdcch_geometry(cell, cfi)
    scr_full = _pdcch_scramble(cell, subframe, 72 * n_cce_tot)
    scr = scr_full[72 * n_cce : 72 * n_cce + 72 * l_aggr]
    sym = modulation.modulate_np(bits ^ scr, 2)
    res = cce_re[n_cce : n_cce + l_aggr].reshape(-1)
    grid.reshape(-1)[res] = sym


def search_space_candidates(n_cce: int, rnti: int, subframe: int, ue_specific: bool = True):
    """Candidate (start_cce, L) list: common (L=4,8) + UE-specific hash
    (36.213 §9.1.1)."""
    cands = []
    for l, m_max in ((4, 4), (8, 2)):
        for m in range(m_max):
            start = m * l
            if start + l <= n_cce:
                cands.append((start, l))
    if ue_specific and rnti:
        y = rnti
        for _ in range(subframe + 1):
            y = (39827 * y) % 65537
        for l, m_max in ((1, 6), (2, 6), (4, 2), (8, 2)):
            if n_cce // l == 0:
                continue
            for m in range(m_max):
                start = l * ((y + m) % (n_cce // l))
                if start + l <= n_cce:
                    cands.append((start, l))
    # dedup preserving order
    seen = set()
    out = []
    for c in cands:
        if c not in seen:
            seen.add(c)
            out.append(c)
    return out


def pdcch_blind_batch(
    cell: Cell,
    grid_eq: jnp.ndarray,
    nv_eff,
    subframe: int,
    cfi: int,
    rnti: int,
    dci_len: int,
    ue_specific: bool = True,
):
    """Batch-first blind DCI search: decode EVERY search-space candidate
    for EVERY batch element in one traced program (jit-friendly — no host
    sync). The reference runs this per-TTI on the worker thread
    (phch_worker.cc:278-326 find_dl_dci_type); here the candidate axis and
    the subframe/carrier batch axis both ride the device.

    grid_eq: [..., n_sym_sf, n_sc] equalized grid(s).
    Returns (hard [..., n_cand, dci_len] uint8 payloads,
             ok   [..., n_cand] bool RNTI-masked CRC16 pass) with the
    candidate order of ``search_space_candidates``.
    """
    n_cce, cce_re = pdcch_geometry(cell, cfi)
    cands = search_space_candidates(n_cce, rnti, subframe, ue_specific)
    if not cands:
        raise ValueError("empty search space")
    scr_full = (1.0 - 2.0 * _pdcch_scramble(cell, subframe, 72 * n_cce)).astype(np.float32)
    n_coded = dci_len + 16
    lead = grid_eq.shape[:-2]

    # group candidates by aggregation level so each group is ONE gather +
    # ONE demap + ONE dematch over a [..., n_c, 36L] block
    bufs_by_cand: dict[int, jnp.ndarray] = {}
    for L in sorted({l for _, l in cands}):
        idx_c = [i for i, (_, l) in enumerate(cands) if l == L]
        res = np.stack([
            cce_re[cands[i][0] : cands[i][0] + L].reshape(-1) for i in idx_c
        ])  # [n_c, 36L]
        scr = np.stack([
            scr_full[72 * cands[i][0] : 72 * (cands[i][0] + L)] for i in idx_c
        ])  # [n_c, 72L]
        y, nv = _gather_re(grid_eq, nv_eff, res.reshape(-1))
        y = y.reshape(lead + res.shape)
        if isinstance(nv, jnp.ndarray) and nv.ndim >= len(lead) + 1 and nv.shape[-1] == res.size:
            nv = nv.reshape(lead + res.shape)
        llr = modulation.demodulate_soft(y, 2, nv)  # [..., n_c, 72L]
        llr = llr * jnp.asarray(scr)
        rm = ratematch.conv_rm_indices(n_coded, 72 * L)
        d = ratematch.dematch(llr, rm, 3 * n_coded)  # [..., n_c, 3*n_coded]
        d = jnp.swapaxes(d.reshape(lead + (len(idx_c), 3, n_coded)), -1, -2)
        for j, i in enumerate(idx_c):
            bufs_by_cand[i] = d[..., j, :, :]
    buffers = jnp.stack([bufs_by_cand[i] for i in range(len(cands))],
                        axis=len(lead))  # [..., n_cand, n_coded, 3]

    flat = buffers.reshape((-1, n_coded, 3))
    hard = convcode.decode(flat).reshape(lead + (len(cands), n_coded))

    # device CRC16 with RNTI mask: one GF(2) matmul over all candidates
    m = np.zeros((n_coded, 16), np.uint8)
    m[:dci_len] = crc.crc_matrix(dci_len, "16")
    m[dci_len:] = np.eye(16, dtype=np.uint8)
    mask_bits = ((rnti >> np.arange(15, -1, -1)) & 1).astype(np.float32)
    syn = jnp.mod(
        jnp.round(hard.astype(jnp.float32) @ jnp.asarray(m.astype(np.float32)))
        + jnp.asarray(mask_bits),
        2.0,
    )
    ok = jnp.sum(syn, axis=-1) == 0
    return hard[..., :dci_len].astype(jnp.uint8), ok


def blind_hits(cands, hard: np.ndarray, ok: np.ndarray, dci_len: int):
    """Host-side hit selection for ONE batch element of
    ``pdcch_blind_batch`` output: list of (start_cce, L, payload_bits),
    deduped by payload (overlapping aggregation levels legitimately
    decode the same circular-buffer codeword — keep the smallest L)."""
    hits = []
    seen = set()
    for (start, l), bits, good in zip(cands, hard, ok):
        if good:
            key = bits[:dci_len].tobytes()
            if key not in seen:
                seen.add(key)
                hits.append((start, l, bits[:dci_len]))
    return hits


def pdcch_blind_decode(
    cell: Cell,
    grid_eq: jnp.ndarray,
    nv_eff,
    subframe: int,
    cfi: int,
    rnti: int,
    dci_len: int,
    ue_specific: bool = True,
):
    """Blind search: batched Viterbi over all candidates for one DCI size.

    grid_eq: [n_sym_sf, n_sc] equalized grid (single subframe).
    Returns list of (start_cce, L, payload_bits) passing the RNTI-masked
    CRC. All candidates decode in ONE device call.
    """
    n_cce, _ = pdcch_geometry(cell, cfi)
    cands = search_space_candidates(n_cce, rnti, subframe, ue_specific)
    if not cands:
        return []
    from ..utils.jaxutil import to_host

    hard, ok = pdcch_blind_batch(
        cell, grid_eq, nv_eff, subframe, cfi, rnti, dci_len, ue_specific
    )
    return blind_hits(cands, to_host(hard), to_host(ok), dci_len)
