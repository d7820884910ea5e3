"""DL HARQ entity — 36.321 §5.3.2 (reference: ue/src/mac/dl_harq.cc).

8 HARQ processes + a dedicated BCCH process (dl_harq.h:47-48 semantics):
NDI-toggle new-transmission detection (dl_harq.cc:191-214), softbuffer
management, ACK generation. The softbuffer is the list of device LLR
arrays produced by ``PdschCodec.dematch`` — combining across
retransmissions is element-wise addition on device (dl_harq.cc:164-171
soft-combine semantics, batched on device).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..phy.cell import DlGrant
from ..phy.pdsch import PdschCodec
from ..utils.jaxutil import to_host

N_HARQ_PROC = 8
BCCH_PID = -1


@dataclass
class _Proc:
    ndi: bool | None = None
    tbs: int = 0
    softbuffers: list | None = None
    decoded: bool = False
    payload: bytes | None = None


class DlHarq:
    """Per-cell DL HARQ entity.

    deliver(pid, payload_bytes, temp_crnti) is the demux handoff
    (mac_interface demux::push_pdu path)."""

    def __init__(self, deliver: Callable[[int, bytes], None]):
        self.procs: dict[int, _Proc] = {p: _Proc() for p in range(N_HARQ_PROC)}
        self.procs[BCCH_PID] = _Proc()
        self.deliver = deliver
        self.metrics = {"rx_ok": 0, "rx_ko": 0, "rx_brate": 0}

    def reset(self) -> None:
        for p in self.procs.values():
            p.ndi = None
            p.softbuffers = None
            p.decoded = False

    def new_grant_dl(self, pid: int, grant: DlGrant) -> bool:
        """Returns True if this is a NEW transmission (reset softbuffer),
        False for a retransmission (keep buffer for combining)."""
        p = self.procs[pid]
        is_new = (
            pid == BCCH_PID  # BCCH: RV-cycled, caller manages epochs
            and p.tbs != grant.tbs
        ) or (
            pid != BCCH_PID
            and (p.ndi is None or grant.ndi != p.ndi or p.tbs != grant.tbs)
        )
        if is_new:
            p.softbuffers = None
            p.decoded = False
            p.payload = None
        p.ndi = grant.ndi
        p.tbs = grant.tbs
        return is_new

    def tb_decoded(
        self, pid: int, codec: PdschCodec, softbuffers: list
    ) -> bool:
        """Combine this transmission's dematched buffers into the process
        softbuffer, decode, and deliver on CRC pass. Returns ACK."""
        p = self.procs[pid]
        if p.decoded:
            return True  # already delivered; just re-ACK
        if p.softbuffers is None:
            p.softbuffers = softbuffers
        else:
            p.softbuffers = [a + b for a, b in zip(p.softbuffers, softbuffers)]
        payload, tb_ok, _, iters = codec.decode_softbuffers(p.softbuffers)
        ok = bool(to_host(tb_ok).all())
        self.metrics["last_iters"] = float(to_host(iters).mean())
        if ok:
            bits = to_host(payload).astype(np.uint8)
            from .pdu import bits_to_bytes

            p.decoded = True
            p.payload = bits_to_bytes(bits.reshape(-1))
            self.deliver(pid, p.payload)
            self.metrics["rx_ok"] += 1
            self.metrics["rx_brate"] += p.tbs
        else:
            self.metrics["rx_ko"] += 1
        return ok
