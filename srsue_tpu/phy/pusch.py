"""PUSCH — UL-SCH transport processing + SC-FDMA (36.212 §5.2.2, 36.211
§5.3-5.5): turbo encode, rate match, scramble, modulate, **DFT precode**,
DMRS generation, grid mapping; plus the eNB-side decode dual for
round-trip tests.

Reference capability: ``srslte_ue_ul_pusch_encode_rnti_softbuffer`` +
``pregen_signals`` (ue/src/phy/phch_worker.cc:545-590, SURVEY.md hot
loop 3).

Design: the DFT precoding is a batched FFT over the allocated
subcarriers (M_sc = 12*n_prb, always 2^a*3^b*5^c by spec — XLA's FFT
handles mixed radix); encoding is host-side bit work per TB (control
plane) feeding one device program for the symbol pipeline. UL DMRS uses
Zadoff-Chu base sequences with cyclic extension (>= 3 PRB; the 1-2 PRB
special tables are a flagged follow-up).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from . import modulation, ratematch, segmentation, seq, turbo
from .cell import Cell, UlGrant

N_DMRS_SYM = (3, 10)  # DMRS symbol positions (normal CP, slot symbol 3)


def _largest_prime_below(n: int) -> int:
    def is_p(k):
        if k < 2:
            return False
        i = 2
        while i * i <= k:
            if k % i == 0:
                return False
            i += 1
        return True

    k = n - 1
    while not is_p(k):
        k -= 1
    return k


@functools.lru_cache(maxsize=256)
def dmrs_base_seq(m_sc: int, u: int, v: int = 0) -> np.ndarray:
    """Zadoff-Chu base sequence r_{u,v}(n) with cyclic extension
    (36.211 §5.5.1.1) for M_sc >= 36 (3+ PRB); 12/24 use the spec's
    phi tables (not yet included)."""
    assert m_sc >= 36, "1-2 PRB DMRS tables not implemented"
    nzc = _largest_prime_below(m_sc)
    q_bar = nzc * (u + 1) / 31
    q = int(np.floor(q_bar + 0.5)) + v * (1 if q_bar % 2 < 1 else -1) * (
        1 if (q_bar - np.floor(q_bar)) < 0.5 else 1
    )
    m = np.arange(nzc)
    x_q = np.exp(-1j * np.pi * q * m * (m + 1) / nzc)
    n = np.arange(m_sc)
    return x_q[n % nzc].astype(np.complex64)


def dmrs_for_slot(cell: Cell, m_sc: int, slot: int, cyclic_shift: int = 0) -> np.ndarray:
    """UL DMRS sequence for one slot (group hopping off: u = cell_id%30)."""
    u = cell.cell_id % 30
    alpha = 2 * np.pi * cyclic_shift / 12
    base = dmrs_base_seq(m_sc, u)
    n = np.arange(m_sc)
    return (base * np.exp(1j * alpha * n)).astype(np.complex64)


ACK_COLS = (2, 3, 8, 9)  # interleaver columns adjacent to the DMRS symbols
RI_COLS = (1, 4, 7, 10)


def uci_layout(m_sc: int, n_cqi_syms: int, n_ack_syms: int):
    """PUSCH channel-interleaver position sets (36.212 §5.2.2.6-8).

    The R x 12 symbol matrix (R = M_sc rows, 12 data SC-FDMA symbol
    columns) is written row-major with [CQI || data] and read
    column-major. Per spec, HARQ-ACK **punctures** already-interleaved
    data: the data stream is laid out over ALL non-CQI positions
    (including the future ACK positions), then ACK symbols overwrite
    bottom-up rows of the DMRS-adjacent columns at transmit time; the
    receiver treats the punctured data bits as erasures (LLR 0).
    Returns (cqi_pos, ack_pos, data_pos) as stream indices in the
    column-major (per-SC-FDMA-symbol) order our mapper uses; ack_pos is
    a subset of data_pos.
    """
    r = m_sc
    c = 12
    ack_pos = []
    for i in range(n_ack_syms):
        col = ACK_COLS[i % 4]
        row = r - 1 - (i // 4)
        ack_pos.append(col * r + row)
    # row-major fill -> column-major stream index, over every position:
    # ACK punctures data after interleaving rather than reserving slots
    order = [col * r + row for row in range(r) for col in range(c)]
    cqi_pos = order[:n_cqi_syms]
    data_pos = order[n_cqi_syms:]
    assert not set(ack_pos) & set(cqi_pos), "ACK/CQI region overlap"
    return (np.asarray(cqi_pos, np.int64), np.asarray(ack_pos, np.int64),
            np.asarray(data_pos, np.int64))


class PuschCodec:
    """Static-config UL-SCH codec (dual of PdschCodec)."""

    def __init__(self, cell: Cell, grant: UlGrant, rnti: int, subframe: int,
                 n_turbo_iters: int = 8, n_cqi_bits: int = 0,
                 with_ack: bool = False, cqi_rep: int = 2, ack_syms: int = 4):
        self.cell = cell
        self.grant = grant
        self.rnti = rnti
        self.subframe = subframe
        self.n_turbo_iters = n_turbo_iters
        self.m_sc = 12 * grant.n_prb
        self.n_data_sym = cell.n_sym_sf - 2  # minus 2 DMRS symbols
        self.n_re = self.m_sc * self.n_data_sym
        self.qm = grant.mod_order

        # UCI-on-PUSCH multiplexing (36.212 §5.2.2.6-8): CQI rides the
        # leading interleaver positions, ACK the DMRS-adjacent columns;
        # data is rate-matched to the remaining REs.
        self.n_cqi_bits = n_cqi_bits
        self.with_ack = with_ack
        n_cqi_syms = -(-20 * cqi_rep // self.qm) if n_cqi_bits else 0
        n_ack_syms = ack_syms if with_ack else 0
        self.cqi_pos, self.ack_pos, self.data_pos = uci_layout(
            self.m_sc, n_cqi_syms, n_ack_syms
        )
        self.cqi_rep = cqi_rep
        # data is rate-matched over all non-CQI positions (ACK punctures
        # it afterwards, 36.212 §5.2.2.6); bit-level erasure mask for RX
        self.G = len(self.data_pos) * self.qm
        self._ack_erase = np.repeat(
            ~np.isin(self.data_pos, self.ack_pos), self.qm
        ).astype(np.float32)

        self.plan = segmentation.plan(grant.tbs)
        p = self.plan
        g_prime = self.G // self.qm
        gamma = g_prime % p.c
        self.E = [
            self.qm * (g_prime // p.c + (1 if i >= p.c - gamma else 0))
            for i in range(p.c)
        ]
        self.e_offsets = np.concatenate([[0], np.cumsum(self.E)]).astype(np.int64)
        self.rm_idx = [
            ratematch.turbo_rm_indices(
                k + 4, self.E[i], grant.rv, n_filler=(p.f if i == 0 else 0)
            )
            for i, k in enumerate(p.block_ks)
        ]
        c_init = (rnti << 14) + (subframe << 9) + cell.cell_id
        self.scr_bits = seq.prs(c_init, self.G)
        self.scr_pm1 = (1.0 - 2.0 * self.scr_bits).astype(np.float32)

    # --------------------------------------------------------------- UE TX
    def encode_bits(self, payload: np.ndarray) -> np.ndarray:
        blocks = segmentation.segment(payload)
        e_bits = []
        for i, blk in enumerate(blocks):
            d = turbo.encode(blk)
            e_bits.append(d.reshape(-1)[self.rm_idx[i]])
        cw = np.concatenate(e_bits)
        return (cw ^ self.scr_bits).astype(np.uint8)

    def encode_sf(self, payload: np.ndarray, cyclic_shift: int = 0) -> np.ndarray:
        """TB -> SC-FDMA time-domain subframe [sf_len] (host+device mix,
        returns numpy)."""
        if self.n_cqi_bits or self.with_ack:
            raise ValueError("UCI-configured codec: use encode_sf_uci")
        cw = self.encode_bits(payload)
        stream = np.zeros(self.n_re, np.complex64)
        stream[self.data_pos] = modulation.modulate_np(cw, self.qm)
        return self.map_waveform(stream, cyclic_shift)

    def encode_sf_uci(self, payload: np.ndarray, cqi_bits=None,
                      ack: bool | None = None, cyclic_shift: int = 0) -> np.ndarray:
        """TB + UCI -> SC-FDMA subframe. cqi_bits: [n_cqi_bits] (RM20-coded
        + circular repetition); ack: HARQ ACK bit (BPSK on reserved
        positions)."""
        from . import uci as ucimod

        stream = np.zeros(self.n_re, np.complex64)
        cw = self.encode_bits(payload)
        stream[self.data_pos] = modulation.modulate_np(cw, self.qm)
        if self.n_cqi_bits:
            assert cqi_bits is not None and len(cqi_bits) == self.n_cqi_bits
            cqi_cw = ucimod.rm20_encode(np.asarray(cqi_bits))
            n_bits = len(self.cqi_pos) * self.qm
            rep = np.tile(cqi_cw, -(-n_bits // 20))[:n_bits]
            stream[self.cqi_pos] = modulation.modulate_np(rep, self.qm)
        if self.with_ack:
            assert ack is not None
            b = 0 if ack else 1
            abits = np.full(len(self.ack_pos) * self.qm, b, np.uint8)
            stream[self.ack_pos] = modulation.modulate_np(abits, self.qm)
        return self.map_waveform(stream, cyclic_shift)

    def map_waveform(self, syms: np.ndarray, cyclic_shift: int = 0) -> np.ndarray:
        cell = self.cell
        m_sc = self.m_sc
        # DFT precode per SC-FDMA data symbol
        data = syms.reshape(self.n_data_sym, m_sc)
        precoded = np.fft.fft(data, axis=-1) / np.sqrt(m_sc)
        grid = np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)
        sc0 = self.grant.prb_start * 12
        di = 0
        for s in range(cell.n_sym_sf):
            if s in N_DMRS_SYM:
                slot = s // cell.n_sym_slot
                grid[s, sc0 : sc0 + m_sc] = dmrs_for_slot(cell, m_sc, slot, cyclic_shift)
            else:
                grid[s, sc0 : sc0 + m_sc] = precoded[di]
                di += 1
        from . import ofdm

        return ofdm.modulate_np(cell, grid)

    def decode_uci(self):
        """Decode the UCI extracted by the last decode_sf call:
        returns (cqi_bits | None, ack | None)."""
        from . import uci as ucimod
        from ..utils.jaxutil import to_host

        cqi_llr, ack_llr = self._last_uci_llrs
        cqi = None
        if cqi_llr is not None:
            flat = to_host(cqi_llr).reshape(-1)
            acc = np.zeros(20, np.float32)
            for i, v in enumerate(flat):
                acc[i % 20] += v
            cqi, _ = ucimod.rm20_decode(acc, self.n_cqi_bits)
        ack = None
        if ack_llr is not None:
            ack = bool(to_host(ack_llr).sum() > 0)
        return cqi, ack

    # ------------------------------------------------------ eNB-side decode
    def dematch_sf(self, iq: jnp.ndarray, noise_var: float = 1e-4,
                   cyclic_shift: int = 0) -> list:
        """IQ -> per-code-block d-domain softbuffers (DMRS-LS chest +
        equalize + IDFT + demap + descramble + rate-dematch). The
        softbuffers are rv-independent: element-wise addition across
        retransmissions (at their respective rv codecs) implements eNB-
        side HARQ combining, the dual of dl_harq.cc:164-171."""
        from . import ofdm

        cell = self.cell
        m_sc = self.m_sc
        grid = ofdm.demodulate(cell, iq)
        sc0 = self.grant.prb_start * 12
        region = grid[..., sc0 : sc0 + m_sc]

        # LS channel estimate from the two DMRS symbols, averaged
        h_est = []
        for s in N_DMRS_SYM:
            slot = s // cell.n_sym_slot
            ref = jnp.asarray(dmrs_for_slot(cell, m_sc, slot, cyclic_shift))
            h_est.append(region[..., s, :] * jnp.conj(ref))
        h = (h_est[0] + h_est[1]) / 2.0  # [..., m_sc]

        data_syms = [s for s in range(cell.n_sym_sf) if s not in N_DMRS_SYM]
        y = region[..., jnp.asarray(np.asarray(data_syms)), :]  # [..., 12, m_sc]
        h2 = jnp.maximum(jnp.abs(h) ** 2, 1e-12)[..., None, :]
        x_eq = y * jnp.conj(h)[..., None, :] / h2
        # IDFT (undo precoding)
        x_td = jnp.fft.ifft(x_eq, axis=-1) * np.sqrt(m_sc)
        syms = x_td.reshape(x_td.shape[:-2] + (-1,))
        nv_eff = noise_var / h2[..., 0, :]
        nv_full = jnp.repeat(nv_eff[..., None, :], len(data_syms), axis=-2
                             ).reshape(syms.shape)
        llr_all = modulation.demodulate_soft(syms, self.qm, nv_full)
        llr_all = llr_all.reshape(llr_all.shape[:-1] + (self.n_re, self.qm))
        llr = llr_all[..., jnp.asarray(self.data_pos), :].reshape(
            llr_all.shape[:-2] + (self.G,)
        )
        llr = llr * jnp.asarray(self.scr_pm1)
        if self.with_ack:
            # ACK punctured these data bits: zero = erasure for the
            # turbo decoder (36.212 §5.2.2.6 receiver dual)
            llr = llr * jnp.asarray(self._ack_erase)
        self._last_uci_llrs = (
            llr_all[..., jnp.asarray(self.cqi_pos), :] if self.n_cqi_bits else None,
            llr_all[..., jnp.asarray(self.ack_pos), :] if self.with_ack else None,
        )

        p = self.plan
        bufs = []
        for i, k in enumerate(p.block_ks):
            lo, hi = int(self.e_offsets[i]), int(self.e_offsets[i + 1])
            d_len = 3 * (k + 4)
            buf = ratematch.dematch(llr[..., lo:hi], self.rm_idx[i], d_len)
            if i == 0 and p.f:
                fl = np.zeros(d_len, np.float32)
                fl[: p.f] = 1e4
                buf = buf + jnp.asarray(fl)
            bufs.append(buf)
        return bufs

    def decode_softbuffers(self, bufs: list):
        """Per-block d-domain softbuffers -> (payload_bits, tb_ok)."""
        from . import crc as crcmod

        p = self.plan
        hard_blocks = []
        oks = []
        for i, k in enumerate(p.block_ks):
            buf = bufs[i]
            kind = "24A" if p.c == 1 else "24B"
            m = np.zeros((k, 24), np.uint8)
            f = p.f if i == 0 else 0
            m[f : k - 24] = crcmod.crc_matrix(k - 24 - f, kind) if p.c == 1 else 0
            if p.c > 1:
                m[: k - 24] = crcmod.crc_matrix(k - 24, "24B")
            m[k - 24 :] = np.eye(24, dtype=np.uint8)
            d = buf.reshape((-1, 3, k + 4))
            hard, iters, ok = turbo.decode(d, k, self.n_turbo_iters, crc_mat=m)
            hard_blocks.append(hard.reshape(buf.shape[:-1] + (k,)))
            oks.append(ok.reshape(buf.shape[:-1]))

        parts = []
        for i, k in enumerate(p.block_ks):
            lo = p.f if i == 0 else 0
            hi = k if p.c == 1 else k - 24
            parts.append(hard_blocks[i][..., lo:hi])
        b_full = jnp.concatenate(parts, axis=-1)
        payload = b_full[..., : self.grant.tbs]
        ok_all = oks[0]
        for o in oks[1:]:
            ok_all = ok_all & o
        return payload, ok_all

    def decode_sf(self, iq: jnp.ndarray, noise_var: float = 1e-4,
                  cyclic_shift: int = 0):
        """Round-trip receiver. iq: [..., sf_len]. Returns
        (payload_bits, tb_ok)."""
        return self.decode_softbuffers(
            self.dematch_sf(iq, noise_var, cyclic_shift)
        )
