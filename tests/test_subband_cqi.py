"""Periodic UE-selected subband CQI (36.213 §7.2.2 Mode 2-0) — VERDICT
r3 item 8 (`format_is_subband`, phch_worker.cc:509-523,755 parity, here
taken further: the reference never implements the subband report path).

The eNB configures cqi-FormatIndicatorPeriodic = subbandCQI(k) in the
ConnectionSetup (full RRC fan-out), a two-tap multipath channel makes
the band frequency-selective, and the eNB's decoded per-part subband
labels must track the strong subbands of the actual channel response."""

import numpy as np
import pytest

from srsue_tpu.phy import ue_ul_ctrl as uc
from test_harq_ota import _attach, _mk


def test_subband_schedule_and_payload():
    """Report-kind cycle (H = J*K + 1) and payload sizes, both ends."""
    n_prb = 15  # k=4, J=2, 4 subbands, 2 per part, L=1
    assert uc.subband_geometry(n_prb) == (4, 2)
    assert uc.subband_count(n_prb) == 4
    assert uc.subband_label_bits(n_prb) == 1
    assert uc.part_subbands(n_prb, 0) == (0, 2)
    assert uc.part_subbands(n_prb, 1) == (2, 4)

    idx = 3  # period 5, offset 1
    kinds = [uc.cqi_report_kind(idx, t, n_prb, 1)
             for t in range(1, 16, 5)]
    assert kinds == [("wb", 0), ("sb", 0), ("sb", 1)]  # H = 3 cycle
    # wideband config: every opportunity is wideband
    assert uc.cqi_report_kind(idx, 6, n_prb, None) == ("wb", 0)
    assert uc.cqi_report_kind(idx, 7, n_prb, 1) is None  # not an opp.

    ctrl = uc.UlCtrl(uc.UlCtrlConfig(cqi_config_index=idx,
                                     cqi_subband_k=1, n_prb=n_prb))
    ctrl.update_snr(15.0)
    ctrl.update_subband_snr([20.0, 5.0, 5.0, 18.0])
    wb = ctrl.cqi_for_tti(1)
    assert len(wb) == 4
    sb0 = ctrl.cqi_for_tti(6)   # part 0: best is subband 0
    assert len(sb0) == 5 and sb0[4] == 0
    sb1 = ctrl.cqi_for_tti(11)  # part 1: best is subband 3 -> label 1
    assert len(sb1) == 5 and sb1[4] == 1
    # subband CQI of the strong subband exceeds the weak ones' level
    cqi0 = int("".join(map(str, sb0[:4])), 2)
    assert cqi0 >= int("".join(map(str, wb)), 2)


def test_subband_occasion_before_first_measurement_keeps_shape():
    """ADVICE r4: on a subband occasion BEFORE any subband measurement
    the payload must keep the subband bit count (4+L) — the eNB derives
    the expected PUCCH format-2 size from the schedule alone, so a 4-bit
    wideband fallback would garble the decode."""
    n_prb = 15
    ctrl = uc.UlCtrl(uc.UlCtrlConfig(cqi_config_index=3,
                                     cqi_subband_k=1, n_prb=n_prb))
    ctrl.update_snr(15.0)
    # no update_subband_snr yet
    assert ctrl.subband_snr_db is None
    sb = ctrl.cqi_for_tti(6)  # a subband occasion in the H=3 cycle
    assert len(sb) == 4 + uc.subband_label_bits(n_prb)
    assert sb[4] == 0  # label 0, wideband CQI in the CQI field
    wb = ctrl.cqi_for_tti(1)  # wideband occasions stay 4-bit
    assert len(wb) == 4


@pytest.mark.slow
def test_subband_cqi_tracks_selective_channel_over_the_air():
    cell, phy, ue, enb_stack, enb = _mk()
    enb_stack.cqi_format_k = 1  # ConnectionSetup carries subbandCQI(k=1)
    rng = np.random.default_rng(9)
    tti0 = _attach(cell, phy, ue, enb_stack, enb, rng) + 1

    # the RRC fan-out delivered the subband format to the UE PHY
    assert phy.ul_ctrl.cfg.cqi_subband_k == 1
    assert enb.cqi_cfg is not None and enb.cqi_cfg[2] == 1

    # speed up the schedule on both ends (period 5, offset 1), keeping
    # the subband format
    phy.configure_cqi(3, 5, subband_k=1)
    enb.cqi_cfg = (3, 5, 1)
    enb.cqi_reports.clear()

    # two-tap multipath: |H(f)|^2 ripples across the band -> distinct
    # strong/weak subbands per bandwidth part
    taps = np.zeros(3, np.complex64)
    taps[0] = 1.0
    taps[2] = 0.85
    nfft, half = cell.nfft, cell.n_sc // 2
    hf = np.fft.fft(taps, nfft)
    bins = np.concatenate([np.arange(nfft - half, nfft),
                           np.arange(1, half + 1)])
    gain_sc = np.abs(hf[bins]) ** 2  # per used subcarrier
    k_sb = 4
    exp_sb = [gain_sc[s * 48: (s + 1) * 48].mean()
              for s in range(3)] + [gain_sc[144:].mean()]
    exp_label = {j: int(np.argmax(exp_sb[2 * j: 2 * j + 2]))
                 for j in range(2)}

    for tti in range(tti0, tti0 + 120):
        dl = enb.build_dl_subframe(tti)
        dl = np.convolve(dl, taps)[: len(dl)].astype(np.complex64)
        ul = phy.work(tti, dl)
        ue.run_tti(tti)
        enb.receive_ul(tti, ul)

    sb_reports = [r for r in enb.cqi_reports
                  if len(r) == 5 and r[1] == "sb"]
    wb_reports = [r for r in enb.cqi_reports if len(r) == 2]
    assert wb_reports, enb.events
    parts_seen = {r[2] for r in sb_reports}
    assert parts_seen == {0, 1}, enb.cqi_reports

    # labels track the channel's strong subband within each part
    for _, _, j, label, cqi in sb_reports:
        assert label == exp_label[j], (j, label, exp_label, exp_sb)
    # the selected subband's CQI is at least the wideband CQI (it is
    # the best subband; wideband averages in the notch)
    best_sb_cqi = max(r[4] for r in sb_reports)
    wb_cqi = max(c for _, c in wb_reports)
    assert best_sb_cqi >= wb_cqi, (best_sb_cqi, wb_cqi)
