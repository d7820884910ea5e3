"""Sync robustness (VERDICT r1 item 4): cold start over an IQ stream
with CFO + sample-clock drift + a mid-stream gap. The receiver must

* acquire the cell and decode MIB (as before),
* TRACK the sample-frequency offset via CP-correlation timing with
  sample-slip compensation (srslte_ue_sync_get_sfo analogue) so the
  subframe alignment survives the drift,
* DETECT the sync loss at the gap and fall back to CELL_SEARCH
  (phch_recv.cc:359-364), then RE-ACQUIRE and keep decoding.
"""

import numpy as np
import pytest

from srsue_tpu.phy import chest, control, equalize, ofdm
from srsue_tpu.phy.cell import Cell
from srsue_tpu.phy.receiver import Receiver
from srsue_tpu.radio import ArrayRadio
from srsue_tpu.utils.jaxutil import to_host
from srsue_tpu.enb.capture import build_downlink as _build_downlink


def _resample(x: np.ndarray, ratio: float) -> np.ndarray:
    """Linear-interpolation resample modeling a sample-clock offset:
    output sample k takes input position k*ratio."""
    pos = np.arange(int(len(x) / ratio)) * ratio
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float32)
    i1 = np.minimum(i0 + 1, len(x) - 1)
    return (x[i0] * (1 - frac) + x[i1] * frac).astype(np.complex64)


def _apply_cfo(x: np.ndarray, cfo_subc: float, nfft: int) -> np.ndarray:
    n = np.arange(len(x))
    return (x * np.exp(2j * np.pi * cfo_subc * n / nfft)).astype(np.complex64)


@pytest.mark.slow
def test_sfo_tracking_keeps_lock():
    """200 ppm sample-clock drift: without slip compensation alignment
    drifts past the CP within ~50 subframes; the tracker must keep PBCH-
    quality lock for 120 subframes and report a matching SFO estimate."""
    cell = Cell(n_prb=6, cell_id=77)
    td, _, _ = _build_downlink(cell, n_frames=14, snr_db=18, sfn0=0)
    ppm = 200e-6
    stream = _resample(td, 1.0 + ppm)  # receiver clock runs fast
    radio = ArrayRadio(np.concatenate(
        [np.zeros(777, np.complex64), stream]), cell.srate)
    rx = Receiver(radio)

    got = list(rx.stream(120))
    assert len(got) == 120, f"lost lock after {len(got)} sf"
    # quality stayed above the loss threshold (no resync needed)
    assert rx.metrics["resyncs"] == 1
    assert rx.state != "CELL_SEARCH"
    # slips happened in the right direction: the resampled stream packs
    # each transmitted subframe into FEWER received samples, so the
    # tracker must rewind (negative slips), ~0.38 samples/subframe
    assert rx.metrics["slips"] <= -10, rx.metrics
    sfo = rx.metrics["sfo_hz"]
    expect = -ppm * cell.srate
    assert 0.5 * abs(expect) < abs(sfo) < 1.7 * abs(expect), (sfo, expect)
    assert np.sign(sfo) == np.sign(expect)


@pytest.mark.slow
def test_gap_triggers_resync_and_recovery():
    """A 25 ms dropout mid-stream: sync loss detected -> CELL_SEARCH ->
    re-acquisition -> CRS/PCFICH decodes again after the gap."""
    cell = Cell(n_prb=6, cell_id=99)
    td1, _, cfi = _build_downlink(cell, n_frames=6, snr_db=18, sfn0=0)
    td2, _, _ = _build_downlink(cell, n_frames=8, snr_db=18, sfn0=32)
    gap = np.zeros(25 * cell.sf_len, np.complex64)
    cfo = 0.21  # subcarrier units (~3.1 kHz)
    stream = _apply_cfo(np.concatenate([td1, gap, td2]), cfo, cell.nfft)
    radio = ArrayRadio(stream, cell.srate)
    rx = Receiver(radio)

    decoded_cfi = []
    states = []
    for tti, iq in rx.stream(100):
        states.append(rx.state)
        sf = tti % 10
        grid = ofdm.demodulate(cell, iq)
        h, nvar, _ = chest.estimate(cell, grid, sf, port=0)
        g_eq, nv_eff = equalize.zf(grid, h, nvar)
        cfi_dev, _ = control.pcfich_decode(cell, g_eq, nv_eff, sf)
        decoded_cfi.append((rx.metrics["resyncs"], int(to_host(cfi_dev))))

    # the stream was interrupted: two acquisitions happened
    assert rx.metrics["resyncs"] == 2, rx.metrics
    before = [c for r, c in decoded_cfi if r == 1]
    after = [c for r, c in decoded_cfi if r == 2]
    assert before and after, (len(before), len(after))
    # PCFICH decodes correctly on both sides of the gap (tail subframes
    # near the dropout may be noise-only; majority must match)
    assert np.mean([c == cfi for c in before[: len(before) - 5]]) > 0.9
    assert np.mean([c == cfi for c in after]) > 0.9
    # CFO was acquired and tracked
    assert abs(rx.metrics["cfo_hz"] - cfo * 15000) < 400, rx.metrics


@pytest.mark.slow
def test_sync_loss_feeds_rrc_rlf_monitor():
    """The receiver's per-subframe sync-quality indications drive the
    RRC radio-link-failure monitor (36.331 §5.3.11): a mid-stream
    dropout produces out-of-sync indications -> N310 -> T310 -> RLF;
    clean subframes produce in-sync indications that keep it armed."""
    from srsue_tpu.rrc.rrc import Rrc, RrcState

    cell = Cell(n_prb=6, cell_id=99)
    td1, _, _ = _build_downlink(cell, n_frames=4, snr_db=18, sfn0=0)
    gap = np.zeros(30 * cell.sf_len, np.complex64)
    radio = ArrayRadio(np.concatenate([td1, gap]), cell.srate)
    rx = Receiver(radio)

    rrc = Rrc()  # standalone monitor: no MAC wired, so RLF -> IDLE
    rrc.state = RrcState.CONNECTED
    rrc.security_activated = False
    rrc.n310, rrc.t310_ms, rrc.n311 = 2, 5, 1
    in_sync = out_sync = 0

    def on_status(ok: bool) -> None:
        nonlocal in_sync, out_sync
        if ok:
            in_sync += 1
            rrc.on_in_sync()
        else:
            out_sync += 1
            rrc.on_out_of_sync()
        rrc.step_tti()  # T310 is wall-clock: one tick per subframe

    rx.on_sync_status = on_status
    for _tti, _iq in rx.stream(60):
        pass

    assert in_sync > 10          # clean subframes reported in-sync
    assert out_sync >= rrc.n310  # the dropout reported out-of-sync
    # N310 out-of-sync -> T310 ran -> expiry -> RLF (no security: IDLE)
    assert rrc.state == RrcState.IDLE
