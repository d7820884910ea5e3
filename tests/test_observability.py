"""pcap writer, logger, metrics table, and the CLI selftest."""

import struct
import subprocess
import sys

import numpy as np
import pytest

from srsue_tpu.utils.metrics import MetricsPrinter, PhyMetricsSnapshot
from srsue_tpu.utils.pcap import DLT_MAC_LTE, MacPcap


def test_pcap_file_structure(tmp_path):
    path = tmp_path / "mac.pcap"
    p = MacPcap(str(path), ue_id=2)
    p.write_dl_sirnti(b"\x40\x05hello", tti=5)
    p.write_ul_crnti(b"\x3d\x21data", rnti=0x4601, tti=8)
    p.close()
    raw = path.read_bytes()
    magic, vmaj, vmin, _, _, snap, dlt = struct.unpack("<IHHiIII", raw[:24])
    assert magic == 0xA1B2C3D4
    assert dlt == DLT_MAC_LTE
    # first record header + context starts with radioType=1(FDD)
    rec_len = struct.unpack("<IIII", raw[24:40])[2]
    ctx = raw[40 : 40 + rec_len]
    assert ctx[0] == 1  # FDD
    assert ctx[1] == 1  # downlink
    assert ctx[2] == 4  # SI-RNTI type
    assert b"\x40\x05hello" in ctx
    assert b"data" in raw


def test_metrics_printer_output():
    import io

    from srsue_tpu.mac.mac import MacMetrics

    buf = io.StringIO()
    mp = MetricsPrinter(out=buf, period_ttis=10)
    phy = PhyMetricsSnapshot(rsrp_dbm=-80, pathloss_db=60, cfo_hz=150,
                             dl_mcs=20, dl_snr_db=25, turbo_iters=1.5)
    m = MacMetrics(rx_pkts=100, rx_errors=1, rx_brate=5_000_000)
    for tti in range(25):
        mp.step(tti, attached=True, phy=phy, mac_metrics=m)
    out = buf.getvalue()
    assert "rsrp" in out  # header printed
    assert "-80.0" in out
    assert out.count("\n") >= 3


def test_logger_tti_stamping(capsys):
    from srsue_tpu.utils import logger as L

    log = L.get_logger("mac", level="info")
    L.step_tti(1234)
    log.info("hello %d", 42)
    err = capsys.readouterr().err
    assert "[ 1234]" in err
    assert "hello 42" in err


def test_cli_selftest():
    """The app-level smoke test: python -m srsue_tpu.main --selftest."""
    r = subprocess.run(
        [sys.executable, "-m", "srsue_tpu.main", "--selftest"],
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": "/root/repo"},
    )
    assert r.returncode == 0, r.stderr + r.stdout
    assert "SELFTEST PASS" in r.stdout
    assert "ul_pkts=True" in r.stdout


def test_phy_metrics_interval_semantics():
    """PHY metrics are incrementally averaged between reads and reset on
    read (phch_common.cc:251-307); MAC metrics zero on read
    (mac.cc:395-400); MABR = 0.8 x MAC MABR(mcs, prb) (phy.cc:118-121)."""
    from srsue_tpu.phy import ra
    from srsue_tpu.phy.cell import Cell
    from srsue_tpu.phy.phy import Phy

    phy = Phy(Cell(n_prb=15, cell_id=1))
    phy._m_add("snr_db", 10.0)
    phy._m_add("snr_db", 30.0)
    phy._m_add("rsrp_dbm", -80.0)
    phy._last_dl_mcs, phy._last_dl_prb = 10, 15
    snap = phy.get_metrics()
    assert snap.dl_snr_db == 20.0  # interval average
    assert snap.rsrp_dbm == -80.0
    mac_mabr = ra.tbs(ra.mcs_to_mod_itbs(10)[1], 15) * 1000 / 1e6
    assert abs(snap.mabr_mbps - 0.8 * mac_mabr) < 1e-9
    # second read: interval reset -> defaults
    snap2 = phy.get_metrics()
    assert snap2.dl_snr_db == 0.0 and snap2.rsrp_dbm == 0.0


def test_live_attach_prints_metrics_table():
    """The 1 Hz table prints from a live OTA attach run with real
    interval metrics (metrics_stdout.cc:85-139 parity)."""
    import io

    import numpy as np

    from srsue_tpu.enb.phy import EnbPhy
    from srsue_tpu.enb.stack import EnbStack
    from srsue_tpu.phy.cell import Cell
    from srsue_tpu.phy.phy import Phy
    from srsue_tpu.ue import Ue

    cell = Cell(n_prb=15, cell_id=123)
    phy = Phy(cell)
    ue = Ue(phy=phy)
    phy.mac = ue.mac
    phy.rrc = ue.rrc
    enb = EnbPhy(cell, EnbStack(ue.usim.cfg))
    rng = np.random.default_rng(0)
    buf = io.StringIO()
    mp = MetricsPrinter(out=buf, period_ttis=50)

    ue.attach()
    ue.rrc.write_pdu_bcch_bch(b"\x00\x00\x00")
    for tti in range(170):
        dl = enb.build_dl_subframe(tti)
        noise = 0.01 * (rng.standard_normal(dl.shape)
                        + 1j * rng.standard_normal(dl.shape)
                        ).astype(np.complex64)
        ul = phy.work(tti, dl + noise)
        ue.run_tti(tti)
        enb.receive_ul(tti, ul)
        # gate on attached like ue::get_metrics (ue.cc:249)
        mp.step(tti, attached=ue.is_attached, phy=phy.get_metrics(),
                mac_metrics=ue.mac.get_metrics())
        if ue.is_attached and buf.getvalue():
            break
    out = buf.getvalue()
    assert "rsrp" in out and out.count("\n") >= 2, out


def test_xla_trace_and_annotate(tmp_path):
    """XLA-profiler hookup (SURVEY §5 tracing; device-level upgrade of
    the reference's exec-time traces): the trace is written, and
    TraceAnnotation spans nest inside it."""
    import jax.numpy as jnp

    from srsue_tpu.utils.trace import XlaTrace, annotate

    with XlaTrace(str(tmp_path / "xprof")) as xt:
        assert xt.active
        with annotate("stage:test"):
            x = jnp.arange(8.0).sum()
    assert float(x) == 28.0
    assert xt.active is False
    files = list((tmp_path / "xprof").rglob("*.xplane.pb"))
    assert files, "profiler ran but wrote no trace"


def test_xla_trace_failure_raises(tmp_path):
    """A profiler that cannot start is reported, not turned into a
    silent no-op: a second trace while one runs is refused."""
    from srsue_tpu.utils.trace import XlaTrace

    with XlaTrace(str(tmp_path / "outer")):
        with pytest.raises(RuntimeError):
            with XlaTrace(str(tmp_path / "inner")):
                pass
