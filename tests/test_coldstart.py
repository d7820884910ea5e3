"""Cold-start E2E: multi-subframe eNB waveform -> ArrayRadio -> cell
search -> MIB -> PCFICH/PDCCH blind SI search -> SIB decode. This is the
reference's "cell_search -> sync_sfn -> steady state" bring-up
(phch_recv.cc:266-375) + ue_itf_test_sib1 pattern, fully hermetic."""

import jax.numpy as jnp
import numpy as np
import pytest

from srsue_tpu.enb.capture import build_downlink as _build_downlink
from srsue_tpu.enb.stack import EnbStack
from srsue_tpu.phy import chest, control, dci, enb_tx, equalize, ofdm, pbch, ra
from srsue_tpu.phy.cell import Cell
from srsue_tpu.phy.pdsch import PdschCodec
from srsue_tpu.phy.receiver import Receiver
from srsue_tpu.radio import ArrayRadio
from srsue_tpu.mac.mac import SI_RNTI
from srsue_tpu.utils.jaxutil import to_host


@pytest.mark.parametrize("cell_id,n_prb", [(123, 25), (47, 6)])
def test_cold_start_to_mib(cell_id, n_prb):
    cell = Cell(n_prb=n_prb, cell_id=cell_id)
    td, _, _ = _build_downlink(cell, n_frames=3, snr_db=12, sfn0=4)
    # random start offset: receiver must find timing itself
    lead = np.zeros(1234, np.complex64)
    radio = ArrayRadio(np.concatenate([lead, td]), cell.srate)
    rx = Receiver(radio)
    found = rx.cell_search()
    assert found is not None, "cell search failed"
    got_id, is_sf5, t_off, cfo = found
    assert got_id == cell_id
    got = rx.decode_mib_stream(got_id, t_off, cfo, is_sf5)
    assert got is not None, "MIB decode failed"
    got_cell, mib, t_next = got
    assert got_cell.n_prb == n_prb
    assert mib.sfn >= 4


def test_cold_start_with_cfo():
    cell = Cell(n_prb=25, cell_id=200)
    td, _, _ = _build_downlink(cell, n_frames=3, snr_db=12)
    n = np.arange(len(td))
    cfo_true = 0.22  # fractional CFO in subcarrier units
    decim = cell.nfft / 128
    td = (td * np.exp(2j * np.pi * cfo_true * n / cell.nfft)).astype(np.complex64)
    radio = ArrayRadio(td, cell.srate)
    rx = Receiver(radio)
    found = rx.cell_search()
    assert found is not None
    got_id, is_sf5, t_off, cfo = found
    assert got_id == 200
    got = rx.decode_mib_stream(got_id, t_off, cfo, is_sf5)
    assert got is not None, f"MIB failed under CFO (est {cfo:.3f})"


def test_cold_start_full_si_acquisition():
    """The full minimum slice (SURVEY.md §7.4 exit criterion): raw IQ ->
    cell found -> MIB -> blind SI-RNTI PDCCH search -> SIB PDSCH decode."""
    cell = Cell(n_prb=25, cell_id=77)
    enb = EnbStack()
    sib1 = enb.make_sib1()
    td, grant, cfi = _build_downlink(
        cell, n_frames=4, sib_payloads={0: sib1, 1: sib1}, snr_db=15
    )
    radio = ArrayRadio(td, cell.srate)
    rx = Receiver(radio)
    found = rx.cell_search()
    assert found is not None
    got_id, is_sf5, t_off, cfo = found
    got = rx.decode_mib_stream(got_id, t_off, cfo, is_sf5)
    assert got is not None
    got_cell, mib, t_next = got
    assert got_cell.n_prb == 25

    # steady-state: walk subframes until an SI subframe (sf5, even SFN).
    # t_next points at the start of the subframe-0 where the MIB was
    # decoded, so the stream resumes exactly at (mib.sfn, sf 0).
    decoded_sib = None
    for tti, iq in rx.subframes(got_cell, t_next, cfo, mib.sfn, 0, n=20):
        sf = tti % 10
        if sf != 5 or (tti // 10) % 2 != 0:
            continue
        grid = ofdm.demodulate(got_cell, iq)
        h, nvar, _ = chest.estimate(got_cell, grid, sf, port=0)
        g_eq, nv_eff = equalize.zf(grid, h, nvar)
        cfi_dev, _ = control.pcfich_decode(got_cell, g_eq, nv_eff, sf)
        got_cfi = int(to_host(cfi_dev))
        assert got_cfi == cfi
        dci_len = dci.size_0_1a(got_cell.n_prb)
        hits = control.pdcch_blind_decode(
            got_cell, g_eq, nv_eff, sf, got_cfi, SI_RNTI, dci_len,
            ue_specific=False,
        )
        if not hits:
            continue
        d = dci.unpack_0_1a(got_cell.n_prb, hits[0][2])
        g = dci.dci1a_to_grant(got_cell, d)
        codec = PdschCodec(got_cell, g, SI_RNTI, sf, got_cfi)
        x_eq, nv = equalize.zf(
            codec.extract_re(grid), codec.extract_re(h), nvar
        )
        payload, tb_ok, _, _ = codec.decode(x_eq, nv)
        if bool(to_host(tb_ok).all()):
            bits = to_host(payload).astype(np.uint8).reshape(-1)
            decoded_sib = np.packbits(bits).tobytes()[: len(sib1)]
            break
    assert decoded_sib == sib1, "SIB1 decode through blind SI search failed"
