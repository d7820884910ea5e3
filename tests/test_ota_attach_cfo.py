"""Over-the-air attach with an injected LO frequency offset — VERDICT
r4 item 4b (UL CFO pre-compensation parity:
/root/reference/ue/src/phy/prach.cc:149-180 CFO-corrects the PRACH
waveform before TX; /root/reference/ue/src/phy/phch_worker.cc:764 sets
the tracked CFO on the whole UL chain).

Physics modeled: the UE's LO is off by +cfo relative to the eNB, so in
the UE's baseband the DL appears rotated by +cfo, and — because TX and
RX share the LO — the UE's UL arrives at the eNB rotated by -cfo. The
UE must (a) track and remove the DL rotation and (b) PRE-rotate its UL
by +cfo so PRACH detection and PUSCH demod at the eNB stay coherent.
Phase is continuous across subframes on both links (a real oscillator
does not reset each millisecond)."""

import numpy as np
import pytest

from srsue_tpu.phy import sync
from test_harq_ota import _mk


def _rot(cell, wf, tti, cfo_norm):
    """Apply a continuous-phase LO rotation of cfo_norm (fraction of the
    subcarrier spacing) to subframe `tti` of a stream."""
    n0 = tti * cell.sf_len
    n = n0 + np.arange(len(wf), dtype=np.float64)
    return (wf * np.exp(2j * np.pi * cfo_norm * n / cell.nfft)
            ).astype(np.complex64)


def _attach_with_cfo(cfo_hz: float, precomp: bool, max_tti=220):
    cell, phy, ue, enb_stack, enb = _mk()
    phy.cfo_track = precomp
    cfo_norm = cfo_hz / 15000.0
    rng = np.random.default_rng(5)
    ue.attach()
    ue.rrc.write_pdu_bcch_bch(b"\x00\x00\x00")
    for tti in range(max_tti):
        dl = enb.build_dl_subframe(tti)
        noise = 0.01 * (rng.standard_normal(dl.shape)
                        + 1j * rng.standard_normal(dl.shape)
                        ).astype(np.complex64)
        # UE sees the DL rotated by +cfo (its LO is low by cfo)
        dl_ue = _rot(cell, dl + noise, tti, +cfo_norm)
        ul = phy.work(tti, dl_ue)
        ue.run_tti(tti)
        if ul is not None:
            # the same LO error lands MIRRORED on the UL at the eNB
            ul = _rot(cell, ul, tti, -cfo_norm)
        enb.receive_ul(tti, ul)
        if ue.is_attached and enb_stack.state == "attached":
            return tti, phy
    return None, phy


@pytest.mark.slow
@pytest.mark.parametrize("cfo_hz", [300.0, -300.0])
def test_ota_attach_with_injected_cfo(cfo_hz):
    """Full attach succeeds across a +-300 Hz LO offset with DL tracking
    + UL pre-compensation on; the tracked estimate converges to the
    injected value."""
    tti, phy = _attach_with_cfo(cfo_hz, precomp=True)
    assert tti is not None, f"attach failed with cfo={cfo_hz} Hz"
    est_hz = phy.cfo_norm * 15000.0
    assert abs(est_hz - cfo_hz) < 60.0, (est_hz, cfo_hz)


@pytest.mark.slow
def test_ota_attach_cfo_uncompensated_fails_at_900hz():
    """Control arm: with tracking/pre-compensation OFF a 900 Hz offset
    breaks the attach — evidence the ±300 Hz pass above is due to the
    compensation, not tolerance elsewhere in the chain. (Measured
    tolerance without compensation: 300-600 Hz still attach, slowly —
    the per-CRS-symbol chest with time interpolation absorbs
    intra-subframe phase ramps, and the eNB's per-slot DMRS
    equalization does the same on the UL — so the uncompensated chain
    only collapses beyond ~0.05 subcarrier spacings.)"""
    tti, _ = _attach_with_cfo(900.0, precomp=False, max_tti=160)
    assert tti is None, f"attach unexpectedly passed at tti={tti}"


@pytest.mark.slow
def test_ota_attach_cfo_compensated_survives_900hz():
    """The compensated receiver attaches through the same 900 Hz offset
    that breaks the uncompensated one, and its tracker converges."""
    tti, phy = _attach_with_cfo(900.0, precomp=True)
    assert tti is not None, "compensated attach failed at 900 Hz"
    assert abs(phy.cfo_norm * 15000.0 - 900.0) < 120.0


def test_cfo_tracking_converges_and_ul_prerotated():
    """Fast (non-slow) loop-level check: feeding CFO-rotated CRS-bearing
    subframes drives phy.cfo_norm to the injected value, and the
    emitted PRACH is pre-rotated by +cfo (detectable after the -cfo
    channel, NOT detectable raw at the eNB)."""
    from srsue_tpu.phy import enb_tx, prach as prach_mod

    cell, phy, ue, enb_stack, enb = _mk()
    cfo_hz = 250.0
    cfo_norm = cfo_hz / 15000.0
    rng = np.random.default_rng(1)
    for tti in range(24):
        grid = enb_tx.empty_grid(cell)
        enb_tx.add_crs(cell, grid, tti % 10, 0)
        enb_tx.add_sync(cell, grid, tti % 10)
        td = enb_tx.to_waveform(cell, [grid])[0]
        td += 0.005 * (rng.standard_normal(td.shape)
                       + 1j * rng.standard_normal(td.shape)
                       ).astype(np.complex64)
        phy.work(tti, _rot(cell, td, tti, cfo_norm))
    est_hz = phy.cfo_norm * 15000.0
    assert abs(est_hz - cfo_hz) < 40.0, est_hz

    # PRACH leaves pre-rotated: after the -cfo UL channel the eNB-side
    # detector sees a clean preamble
    phy.prach_send(7, 0.0, tti)
    ul = phy.work(cell.sf_len // cell.sf_len * 10 + 1,  # PRACH_SF == 1
                  _rot(cell, td, 25, cfo_norm))
    assert ul is not None
    at_enb = _rot(cell, ul, 0, -cfo_norm)
    det = prach_mod.detect(cell, at_enb, phy.prach_root, phy.prach_zcorr)
    assert det and det[0][0] == 7, det
