"""Seeded downlink captures from the in-repo eNB transmitter: what a UE
would record from a live cell, for the ``--iq`` entry point and the
cold-start tests."""

from __future__ import annotations

import numpy as np

from ..mac.mac import SI_RNTI
from ..phy import control, dci, enb_tx, pbch, ra
from ..phy.pdsch import PdschCodec


def build_downlink(cell, n_frames=3, sib_payloads=None, snr_db=15, seed=0,
                    mcs_si=3, sfn0=0, crnti=0, mcs_data=8, data_sfs=(3,)):
    """Generate n_frames of a live cell: CRS everywhere, PSS/SSS in sf0/5,
    PBCH in sf0, SIB PDSCH (DCI 1A on SI-RNTI) in sf5, and optional
    C-RNTI data PDSCH in `data_sfs`."""
    rng = np.random.default_rng(seed)
    sib_payloads = sib_payloads or {}
    grant = ra.dl_grant(cell.n_prb, mcs_si)
    data_grant = ra.dl_grant(cell.n_prb, mcs_data)
    cfi = 2
    sfs = []
    for f in range(n_frames):
        sfn = sfn0 + f
        for sf in range(10):
            grid = enb_tx.empty_grid(cell)
            enb_tx.add_crs(cell, grid, sf, 0)
            enb_tx.add_sync(cell, grid, sf)
            control.pcfich_map(cell, grid, sf, cfi)
            if crnti and sf in data_sfs:
                dcodec = PdschCodec(cell, data_grant, crnti, sf, cfi)
                dd = dci.Dci1A(riv=dci.riv_encode(cell.n_prb, 0, cell.n_prb),
                               mcs=mcs_data, harq_pid=0, ndi=True, rv=0, tpc=0)
                n_cce, _ = control.pdcch_geometry(cell, cfi)
                cands = control.search_space_candidates(n_cce, crnti, sf)
                start, l = [c for c in cands if c[1] >= 4][0]
                control.pdcch_map(cell, grid, sf, cfi,
                                  dci.pack_1a(cell.n_prb, dd), crnti, start, l)
                pl = rng.integers(0, 2, data_grant.tbs).astype(np.uint8)
                dcodec.map_to_grid(grid, dcodec.encode_symbols(pl))
            if sf == 0:
                mib = pbch.Mib(cell.n_prb, "normal", 1.0, sfn)
                cw = pbch.encode(cell, mib, n_ports=1)
                pbch.map_to_grid(cell, grid, pbch.frame_symbols(cell, cw, sfn % 4))
            if sf == 5 and (sfn % 2 == 0) and sib_payloads:
                # SI window: DCI 1A on SI-RNTI + PDSCH with the SIB
                codec = PdschCodec(cell, grant, SI_RNTI, sf, cfi)
                payload = sib_payloads.get(f % len(sib_payloads), None)
                if payload is not None:
                    d = dci.Dci1A(riv=dci.riv_encode(cell.n_prb, 0, cell.n_prb),
                                  mcs=mcs_si, harq_pid=0, ndi=False, rv=0, tpc=0)
                    control.pdcch_map(cell, grid, sf, cfi,
                                      dci.pack_1a(cell.n_prb, d), SI_RNTI, 0, 4)
                    bits = np.zeros(grant.tbs, np.uint8)
                    pb = np.unpackbits(np.frombuffer(payload, np.uint8))
                    bits[: len(pb)] = pb
                    codec.map_to_grid(grid, codec.encode_symbols(bits))
            sfs.append(enb_tx.to_waveform(cell, [grid])[0])
    td = np.concatenate(sfs)
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    noisy, nv = enb_tx.awgn(rng, td, snr_db, signal_power=p_sig)
    return noisy, grant, cfi
