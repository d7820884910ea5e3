"""Live socket radio (radio/socket_radio.py) — the RF-less stand-in for
radio_uhd (SURVEY §2.5): a peer process/thread streams DL IQ; the UE
receiver acquires the cell + MIB over the live stream; timed UL bursts
cross back with their tx_time framing intact."""

import sys

import numpy as np
import pytest

from srsue_tpu.phy.cell import Cell
from srsue_tpu.radio import IqPeer, SocketRadio

sys.path.insert(0, "tests")


def test_rx_stream_and_timed_tx():
    peer = IqPeer()
    data = (np.arange(4096) + 1j * np.arange(4096)).astype(np.complex64)
    peer.serve_dl(data)
    peer.collect_ul()

    r = SocketRadio(peer.host, peer.rx_port, peer.tx_port, srate=1.92e6, agc=False)
    a, ts0 = r.rx_now(1000)
    b, ts1 = r.rx_now(3096)
    np.testing.assert_array_equal(np.concatenate([a, b]), data)
    assert ts0 == 0.0 and abs(ts1 - 1000 / 1.92e6) < 1e-12

    # short read past EOF: zero-padded + underflow counted (the O/U/L
    # surfacing contract of radio_uhd / ue.cc:271-292)
    c, _ = r.rx_now(64)
    assert np.all(c == 0) and r.underflows == 1 and r.exhausted

    burst = np.exp(2j * np.pi * np.arange(192) / 7).astype(np.complex64)
    r.tx(burst, tx_time=0.004)
    r.tx(burst[:10], tx_time=0.008, eob=True)
    r.close()
    peer.join()
    assert len(peer.ul_bursts) == 2
    t0, f0, iq0 = peer.ul_bursts[0]
    t1, f1, iq1 = peer.ul_bursts[1]
    assert (t0, f0) == (0.004, 0) and (t1, f1) == (0.008, 1)
    np.testing.assert_array_equal(iq0, burst)
    np.testing.assert_array_equal(iq1, burst[:10])
    peer.close()


@pytest.mark.parametrize("level_db", [0.0, -20.0, 20.0])
def test_cell_acquisition_over_live_socket(level_db):
    """Cold-start cell search + MIB decode with the receiver pulling
    subframes from a live socket stream instead of a file — across a
    +-20 dB input-level sweep handled by the digital AGC (the
    phch_recv.cc:96-134 gain-loop role; VERDICT r3 item 9)."""
    from srsue_tpu.enb.capture import build_downlink as _build_downlink

    from srsue_tpu.phy.receiver import Receiver

    cell = Cell(n_prb=6, cell_id=97)
    td, _, _ = _build_downlink(cell, n_frames=4, snr_db=15, sfn0=2)
    scale = 10 ** (level_db / 20)

    peer = IqPeer()
    peer.serve_dl(td * scale)
    radio = SocketRadio(peer.host, peer.rx_port, srate=cell.srate)
    rx = Receiver(radio)
    found = rx.cell_search()
    assert found is not None
    cell_id, is_sf5, t_off, cfo = found
    assert cell_id == 97
    got = rx.decode_mib_stream(cell_id, t_off, cfo, is_sf5)
    assert got is not None
    got_cell, mib, _ = got
    assert got_cell.n_prb == 6
    # the AGC converged near the inverse of the served level (waveform
    # RMS x sweep scale)
    rms_in = float(np.sqrt(np.mean(np.abs(td * scale) ** 2)))
    agc_db = 20 * np.log10(radio.agc.gain * rms_in)
    assert abs(agc_db) < 4.0, (agc_db, level_db)
    # the applied gain is REPORTED so absolute-power consumers can
    # refer measurements back to the antenna (ADVICE r4); the Phy
    # consumes it as rx_gain_offset_db in its dBm conversions
    assert radio.rx_gain_db == pytest.approx(
        20 * np.log10(radio.agc.gain), abs=1e-6)
    radio.close()
    peer.close()


def test_cli_live_tcp_attach():
    """App surface over the live socket radio: `--iq-tcp host:port`
    acquires the cell + MIB from a peer streaming DL IQ."""
    import subprocess

    from srsue_tpu.enb.capture import build_downlink as _build_downlink

    cell = Cell(n_prb=6, cell_id=151)
    td, _, _ = _build_downlink(cell, n_frames=4, snr_db=12)
    peer = IqPeer()
    peer.serve_dl(td)
    r = subprocess.run(
        [sys.executable, "-m", "srsue_tpu.main",
         "--iq-tcp", f"{peer.host}:{peer.rx_port}",
         "--srate", str(cell.srate)],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": "/root/repo"},
    )
    peer.close()
    assert r.returncode == 0, r.stderr
    assert "cell_id=151" in r.stderr
    assert "n_prb=6" in r.stderr
    assert "processed" in r.stderr
