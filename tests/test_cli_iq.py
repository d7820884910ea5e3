"""CLI --iq attach: generate a capture, run the app as a subprocess,
assert cell/MIB acquisition output (the app-surface E2E drive) + trace
subsystem round-trip + pcap from selftest."""

import subprocess
import sys

import numpy as np

from srsue_tpu.phy.cell import Cell
from srsue_tpu.radio.radio import write_iq
from srsue_tpu.utils.trace import StageTimer, Trace


def test_cli_iq_attach(tmp_path):
    # build 4 frames of a live 1.4 MHz cell (reuse the coldstart builder)
    from srsue_tpu.enb.capture import build_downlink as _build_downlink

    cell = Cell(n_prb=6, cell_id=151)
    td, _, _ = _build_downlink(cell, n_frames=4, snr_db=12)
    path = tmp_path / "cap.iq"
    write_iq(str(path), td)

    r = subprocess.run(
        [sys.executable, "-m", "srsue_tpu.main", "--iq", str(path),
         "--srate", str(cell.srate)],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": "/root/repo"},
    )
    assert r.returncode == 0, r.stderr
    assert "cell_id=151" in r.stderr
    assert "n_prb=6" in r.stderr
    assert "processed" in r.stderr


def test_cli_iq_data_decode(tmp_path):
    """--rnti mode: the app decodes C-RNTI PDSCH data in the steady loop
    (the streaming-receiver surface)."""
    from srsue_tpu.enb.capture import build_downlink as _build_downlink

    cell = Cell(n_prb=6, cell_id=77)
    td, _, _ = _build_downlink(cell, n_frames=4, snr_db=15, crnti=0x4601,
                               mcs_data=6)
    path = tmp_path / "cap_data.iq"
    write_iq(str(path), td)

    r = subprocess.run(
        [sys.executable, "-m", "srsue_tpu.main", "--iq", str(path),
         "--srate", str(cell.srate), "--rnti", "0x4601"],
        capture_output=True, text=True, timeout=500,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": "/root/repo"},
    )
    assert r.returncode == 0, r.stderr
    assert "decoded" in r.stderr
    import re

    m = re.search(r"decoded (\d+) TBs", r.stderr)
    assert m and int(m.group(1)) >= 2, r.stderr


def test_selftest_writes_pcap(tmp_path):
    pcap = tmp_path / "ue.pcap"
    r = subprocess.run(
        [sys.executable, "-m", "srsue_tpu.main", "--selftest",
         "--pcap", str(pcap)],
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": "/root/repo"},
    )
    assert r.returncode == 0, r.stderr + r.stdout
    raw = pcap.read_bytes()
    assert len(raw) > 24  # header + at least one UL record
    assert raw[:4] == b"\xd4\xc3\xb2\xa1"


def test_trace_roundtrip(tmp_path):
    tr = Trace(capacity=8)
    for tti in range(12):  # wraps the ring
        with StageTimer(tr, tti):
            pass
    p = tmp_path / "t.bin"
    tr.dump(str(p))
    ttis, vals = Trace.load(str(p))
    assert list(ttis) == list(range(4, 12))
    assert (vals >= 0).all()
