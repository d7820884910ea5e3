"""UL power control / periodic CQI / SRS in the LIVE loop (VERDICT r1
item 3): after an over-the-air attach,

* periodic CQI rides PUCCH format 2 (or PUSCH when a grant coincides) at
  the configured (period, offset) and the eNB decodes values matching
  the UE's measured SNR (phch_worker.cc:479-527),
* SRS transmits on the UE-specific schedule and the eNB detects it
  (phch_worker.cc:531-532, 636-658),
* open-loop power control makes transmit power track pathloss with
  partial compensation (alpha < 1): PUCCH/PRACH fully compensate, PUSCH
  arrives at 10^(-(1-alpha)*PL/20) of nominal amplitude; PHR drops by
  alpha*PL (phch_worker.cc:545-658, set_ul_params 677-766).
"""

import numpy as np
import pytest

from srsue_tpu.phy import ra
from srsue_tpu.phy.ue_ul_ctrl import cqi_period_offset
from srsue_tpu.phy import srs as srsmod
from test_harq_ota import _attach, _mk


@pytest.mark.slow
def test_cqi_srs_power_over_the_air():
    cell, phy, ue, enb_stack, enb = _mk()
    rng = np.random.default_rng(9)
    tti0 = _attach(cell, phy, ue, enb_stack, enb, rng) + 1

    # dedicated config fan-out: CQI every 5 ms (offset 1), SRS every
    # 10 ms at subframe 4 (no collision with PUSCH sf8 / DL-data ACKs at
    # sf7+4/sf3+4 / SR) — on both ends
    cqi_idx, n_pucch_cqi = 3, 5
    srs_idx, srs_prb = 11, 4
    phy.configure_cqi(cqi_idx, n_pucch_cqi)
    phy.configure_srs(srs_idx, srs_prb)
    enb.cqi_cfg = (cqi_idx, n_pucch_cqi, None)
    enb.srs_cfg = (srs_idx, srs_prb)
    # reports produced during attach under the INITIAL dedicated config
    # (cqi-pmi-ConfigIndex 40: period 40, offset 3) are valid but belong
    # to the old schedule — judge only the reconfigured one. (Whether any
    # exist depends on how many TTIs attach took, which can shift by a
    # HARQ retx.)
    enb.cqi_reports.clear()

    pl_db = 6.0
    g = 10 ** (-pl_db / 20)  # channel amplitude attenuation both ways

    phr_before = phy.get_headroom_db()
    pusch_p = {"clear": [], "atten": []}
    for phase, atten in (("clear", 1.0), ("atten", g)):
        t0 = ue.mac.tti + 1 if phase == "atten" else tti0
        for tti in range(t0, t0 + 60):
            dl = enb.build_dl_subframe(tti) * atten
            ul = phy.work(tti, dl)
            ue.run_tti(tti)
            if ul is not None and phy._phich_wait.get(tti + 4) == tti:
                pusch_p[phase].append(float(np.mean(np.abs(ul) ** 2)))
            enb.receive_ul(tti, None if ul is None else ul * atten)

    # --- CQI received at the configured opportunities with sane values
    period, offset = cqi_period_offset(cqi_idx)
    assert enb.cqi_reports, enb.events
    for tti, cqi in enb.cqi_reports:
        assert tti % period == offset
        expect = ra.cqi_from_snr(phy.ul_ctrl.last_snr_db)
        assert abs(cqi - expect) <= 3, (cqi, expect)
    assert phy.metrics["cqi_tx"] >= len(enb.cqi_reports) > 3

    # --- SRS detected on the UE-specific schedule
    assert enb.srs_detects, enb.events
    for tti, m in enb.srs_detects:
        assert srsmod.ue_srs_subframe(srs_idx, tti)
    assert phy.metrics["srs_tx"] >= 1

    # --- power control: pathloss measured; headroom drops by at least
    # the open-loop term alpha*PL, and by at most full PL compensation
    # (the eNB's closed-loop TPC tops up the fractional-alpha gap
    # (1-alpha)*PL over the phase)
    assert abs(phy.pathloss_db - pl_db) < 1.5, phy.pathloss_db
    phr_after = phy.get_headroom_db()
    alpha = phy.ul_power.cfg.alpha
    drop = phr_before - phr_after
    assert alpha * pl_db - 1.5 < drop < pl_db + 1.5, (phr_before, phr_after)
    # UE-side transmit power (pre-channel) rose by alpha*PL..PL in dB.
    # Compare END-of-phase transmissions: phase means are depressed by
    # the closed-loop transient (TPC still stepping at phase start).
    if len(pusch_p["clear"]) >= 2 and len(pusch_p["atten"]) >= 2:
        gain_db = 10 * np.log10(np.mean(pusch_p["atten"][-2:])
                                / np.mean(pusch_p["clear"][-2:]))
        assert alpha * pl_db - 1.5 < gain_db < pl_db + 1.5, gain_db
