"""PDSCH transport-channel processing — the end-to-end DL-SCH codec
(36.212 §5.3.2 + 36.211 §6.3/6.4).

This is the "forward pass" of the framework: the capability surface of
``srslte_pdsch_decode_rnti`` + ``srslte_softbuffer_rx`` + segmentation
(SURVEY.md §2.1, §3.2 hot loop 2). A ``PdschCodec`` instance is the
host-side precompute for one static (cell, grant-bucket, rnti, subframe,
cfi) configuration: segmentation plan, per-block rate-matching index maps,
scrambling sequence, RE map, CRC matrices. Its ``decode`` method is a pure
jittable device function over batched inputs; HARQ soft-combining is plain
addition of the returned ``softbuffer`` arrays (dl_harq.cc:164-171
semantics).

The eNB-side ``encode`` (host numpy) exists to generate golden test
vectors and benchmark inputs — the reference has no in-repo DSP golden
source (srsLTE is external), so TX->channel->RX round-trips are the
correctness contract (SURVEY.md §4 'Implication').
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import (crc, modulation, ratematch, regrid, segmentation, seq, turbo,
               turbo_pallas)
from .cell import Cell, DlGrant
from ..utils.jaxutil import cgather

FILLER_LLR = 1e4  # known-zero filler bits: saturated "bit 0" prior


def _turbo_decode(d, k, n_iters, crc_mat, early_exit=True):
    """Pick the BCJR backend: the fused Pallas kernel on a GPU (one launch
    per half-iteration instead of a launch per trellis step), the
    lax.scan decoder elsewhere and for K too short for windows."""
    if jax.default_backend() == "gpu" and turbo.pick_window(k) is not None:
        return turbo_pallas.decode(d, k, n_iters=n_iters, crc_mat=crc_mat,
                                   early_exit=early_exit)
    return turbo.decode(d, k, n_iters=n_iters, crc_mat=crc_mat,
                        early_exit=early_exit)


class PdschCodec:
    """Static-shape PDSCH encoder/decoder for one configuration bucket."""

    def __init__(
        self,
        cell: Cell,
        grant: DlGrant,
        rnti: int,
        subframe: int,
        cfi: int = 1,
        n_turbo_iters: int = 8,
        early_exit: bool = True,
    ):
        self.cell = cell
        self.grant = grant
        self.rnti = rnti
        self.subframe = subframe
        self.cfi = cfi
        self.n_turbo_iters = n_turbo_iters
        self.early_exit = early_exit

        self.re_idx = regrid.pdsch_re(
            cell, subframe, cfi, grant.prb_start, grant.n_prb
        )
        self.n_re = len(self.re_idx)
        self.qm = grant.mod_order
        self.G = self.n_re * self.qm

        self.plan = segmentation.plan(grant.tbs)
        p = self.plan
        # 36.212 §5.1.4.1.2 bit selection: E per code block (N_L = 1)
        g_prime = self.G // self.qm
        gamma = g_prime % p.c
        self.E = [
            self.qm * (g_prime // p.c + (1 if i >= p.c - gamma else 0))
            for i in range(p.c)
        ]
        self.e_offsets = np.concatenate([[0], np.cumsum(self.E)]).astype(np.int64)
        assert self.e_offsets[-1] == self.G

        self.block_ks = p.block_ks
        self.rm_idx = [
            ratematch.turbo_rm_indices(
                k + 4, self.E[i], grant.rv, n_filler=(p.f if i == 0 else 0)
            )
            for i, k in enumerate(self.block_ks)
        ]

        # scrambling (36.211 §6.3.1): c_init = rnti*2^14 + q*2^13 +
        # floor(ns/2)*2^9 + cell_id, q = 0 (one codeword)
        c_init = (rnti << 14) + (subframe << 9) + cell.cell_id
        self.scr_bits = seq.prs(c_init, self.G)
        self.scr_pm1 = (1.0 - 2.0 * self.scr_bits).astype(np.float32)

        # device CRC syndrome matrices
        self._blk_crc = {}
        for i, k in enumerate(self.block_ks):
            f = p.f if i == 0 else 0
            if p.c == 1:
                m = np.zeros((k, 24), np.uint8)
                m[f : k - 24] = crc.crc_matrix(k - 24 - f, "24A")
                m[k - 24 :] = np.eye(24, dtype=np.uint8)
            else:
                m = np.zeros((k, 24), np.uint8)
                m[: k - 24] = crc.crc_matrix(k - 24, "24B")
                m[k - 24 :] = np.eye(24, dtype=np.uint8)
            self._blk_crc[k] = m
        self._tb_crc = crc.crc_matrix(grant.tbs, "24A")

    # ------------------------------------------------------------------ TX
    def encode(self, payload: np.ndarray) -> np.ndarray:
        """TB payload bits [tbs] -> scrambled codeword bits [G] (host)."""
        assert len(payload) == self.grant.tbs
        blocks = segmentation.segment(payload)
        e_bits = []
        for i, blk in enumerate(blocks):
            d = turbo.encode(blk)  # [3, K+4]
            d_flat = d.reshape(-1)
            e_bits.append(d_flat[self.rm_idx[i]])
        cw = np.concatenate(e_bits)
        return (cw ^ self.scr_bits).astype(np.uint8)

    def encode_symbols(self, payload: np.ndarray) -> np.ndarray:
        """TB payload -> modulated symbols [n_re] complex64 (host)."""
        cw = self.encode(payload)
        return modulation.modulate_np(cw, self.qm)

    def map_to_grid(self, grid: np.ndarray, symbols: np.ndarray) -> None:
        """In-place RE mapping into a [n_sym_sf, n_sc] numpy grid."""
        flat = grid.reshape(-1)
        flat[self.re_idx] = symbols

    def map_to_grid_tm2(self, grids: list, symbols: np.ndarray) -> None:
        """2-port SFBC mapping (36.211 §6.3.4.3) onto per-port grids."""
        from . import control

        p0, p1 = control._sfbc_precode(symbols)
        grids[0].reshape(-1)[self.re_idx] = p0
        grids[1].reshape(-1)[self.re_idx] = p1

    # ------------------------------------------------------------------ RX
    def extract_re(self, grid: jnp.ndarray) -> jnp.ndarray:
        """[..., n_sym_sf, n_sc] -> [..., n_re] (complex-safe gather)."""
        flat = grid.reshape(grid.shape[:-2] + (-1,))
        return cgather(flat, jnp.asarray(self.re_idx), axis=-1)

    def demap_llrs(self, x_eq: jnp.ndarray, nv_eff) -> jnp.ndarray:
        """Equalized PDSCH symbols -> descrambled LLRs [..., G]."""
        llr = modulation.demodulate_soft(x_eq, self.qm, nv_eff)
        return llr * jnp.asarray(self.scr_pm1)

    def dematch(self, llrs: jnp.ndarray) -> list[jnp.ndarray]:
        """Descrambled LLRs [..., G] -> per-K-group softbuffers.

        Returns a list with one [..., n_blocks, 3*(K+4)] array per distinct
        K (at most 2 groups: K- then K+). Adding softbuffers across
        retransmissions implements HARQ combining.
        """
        p = self.plan
        groups = []
        # group blocks by K preserving order (K- blocks come first)
        uniq = []
        for k in self.block_ks:
            if not uniq or uniq[-1][0] != k:
                uniq.append([k, 0, 0])
            uniq[-1][2] += 1
        pos = 0
        for g in uniq:
            g[1] = pos
            pos += g[2]
        for k, start, count in uniq:
            d_len = 3 * (k + 4)
            bufs = []
            for b in range(start, start + count):
                lo, hi = int(self.e_offsets[b]), int(self.e_offsets[b + 1])
                seg = llrs[..., lo:hi]
                buf = ratematch.dematch(seg, self.rm_idx[b], d_len)
                if b == 0 and p.f:
                    # known-zero fillers -> saturated prior in d0
                    filler = jnp.zeros((d_len,), llrs.dtype)
                    filler = filler.at[: p.f].set(FILLER_LLR)
                    buf = buf + filler
                bufs.append(buf)
            groups.append(jnp.stack(bufs, axis=-2))
        return groups

    def decode_softbuffers(self, groups: list[jnp.ndarray]):
        """Softbuffer groups -> (tb_payload [..., tbs] uint8,
        tb_ok [...] bool, blk_ok [..., C] bool, iters [..., C] int32)."""
        p = self.plan
        hard_blocks = []
        oks = []
        iters_all = []
        gi = 0
        for k in dict.fromkeys(self.block_ks):  # ordered unique
            buf = groups[gi]
            gi += 1
            lead = buf.shape[:-2]
            count = buf.shape[-2]
            d = buf.reshape((-1, 3, k + 4))
            hard, iters, ok = _turbo_decode(
                d, k, self.n_turbo_iters, self._blk_crc[k],
                early_exit=self.early_exit,
            )
            hard = hard.reshape(lead + (count, k))
            hard_blocks.append(hard)
            oks.append(ok.reshape(lead + (count,)))
            iters_all.append(iters.reshape(lead + (count,)))

        hard_cat = jnp.concatenate(
            [h.reshape(h.shape[:-2] + (-1,)) for h in hard_blocks], axis=-1
        )
        blk_ok = jnp.concatenate(oks, axis=-1)
        iters = jnp.concatenate(iters_all, axis=-1)

        # assemble TB bits (static slices per block)
        parts = []
        off = 0
        for i, k in enumerate(self.block_ks):
            blk = hard_cat[..., off : off + k]
            off += k
            lo = p.f if i == 0 else 0
            hi = k if p.c == 1 else k - 24
            parts.append(blk[..., lo:hi])
        b_full = jnp.concatenate(parts, axis=-1)  # [..., tbs+24]
        payload = b_full[..., : self.grant.tbs]
        if p.c == 1:
            tb_ok = blk_ok[..., 0]
        else:
            syn = jnp.mod(
                jnp.round(
                    b_full[..., : self.grant.tbs].astype(jnp.float32)
                    @ jnp.asarray(self._tb_crc.astype(np.float32))
                )
                + jnp.round(b_full[..., self.grant.tbs :].astype(jnp.float32)),
                2.0,
            )
            tb_ok = (jnp.sum(syn, axis=-1) == 0) & jnp.all(blk_ok, axis=-1)
        return payload.astype(jnp.uint8), tb_ok, blk_ok, iters

    def decode(self, x_eq: jnp.ndarray, nv_eff):
        """Full device decode: equalized symbols [..., n_re] (+ per-RE
        noise) -> (payload, tb_ok, blk_ok, iters). Jit-friendly."""
        llrs = self.demap_llrs(x_eq, nv_eff)
        groups = self.dematch(llrs)
        return self.decode_softbuffers(groups)


@functools.lru_cache(maxsize=256)
def codec(cell: Cell, grant: DlGrant, rnti: int, subframe: int, cfi: int = 1,
          n_turbo_iters: int = 8) -> PdschCodec:
    return PdschCodec(cell, grant, rnti, subframe, cfi, n_turbo_iters)
