"""PBCH / MIB — 36.211 §6.6, 36.212 §5.3.1.

Capability parity with ``srslte_pbch_decode_reset`` / ``srslte_pbch_mib_unpack``
consumed by the reference's cell search (ue/src/phy/phch_recv.cc:96-264).

The 1920-bit (normal CP) PBCH codeword spans 4 radio frames (40 ms TTI);
a UE that just woke up does not know which quarter it is observing, nor
the eNB port count. Design: ALL hypotheses (4 quarter offsets x port
configs) are decoded as one batched Viterbi call — no sequential trial
loop — and the CRC16 antenna-mask check picks the winner on device.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from . import convcode, crc, modulation, ratematch, regrid, seq
from .cell import Cell

MIB_LEN = 24
CODED = MIB_LEN + 16  # +CRC16
E_TOTAL = 1920  # normal CP
E_FRAME = 480

# CRC16 antenna masks (36.212 Table 5.3.1.1-1)
ANT_MASK = {1: 0x0000, 2: 0xFFFF, 4: 0x5555}

PRB_CODE = {6: 0, 15: 1, 25: 2, 50: 3, 75: 4, 100: 5}
CODE_PRB = {v: k for k, v in PRB_CODE.items()}


@dataclass(frozen=True)
class Mib:
    n_prb: int
    phich_duration: str  # "normal" | "extended"
    phich_resources: float  # 1/6, 1/2, 1, 2
    sfn: int  # frame number (8 MSBs from MIB; 2 LSBs from quarter offset)


_PHICH_RES = [1 / 6, 1 / 2, 1.0, 2.0]


def pack_mib(mib: Mib) -> np.ndarray:
    bits = np.zeros(MIB_LEN, np.uint8)
    bw = PRB_CODE[mib.n_prb]
    bits[0:3] = [(bw >> i) & 1 for i in (2, 1, 0)]
    bits[3] = 0 if mib.phich_duration == "normal" else 1
    ng = _PHICH_RES.index(mib.phich_resources)
    bits[4:6] = [(ng >> i) & 1 for i in (1, 0)]
    sfn8 = (mib.sfn >> 2) & 0xFF
    bits[6:14] = [(sfn8 >> i) & 1 for i in range(7, -1, -1)]
    return bits


def unpack_mib(bits: np.ndarray, quarter: int) -> Mib:
    b = np.asarray(bits).astype(np.int64)
    bw = (b[0] << 2) | (b[1] << 1) | b[2]
    dur = "normal" if b[3] == 0 else "extended"
    ng = _PHICH_RES[(b[4] << 1) | b[5]]
    sfn8 = 0
    for i in range(8):
        sfn8 = (sfn8 << 1) | b[6 + i]
    return Mib(CODE_PRB.get(int(bw), 6), dur, ng, (int(sfn8) << 2) | quarter)


def _scramble_seq(cell_id: int) -> np.ndarray:
    return seq.prs(cell_id, E_TOTAL)


def encode(cell: Cell, mib: Mib, n_ports: int = 1) -> np.ndarray:
    """MIB -> the full 1920-bit scrambled PBCH codeword (all 4 frames)."""
    b = crc.attach(pack_mib(mib), "16", mask=ANT_MASK[n_ports])
    coded = convcode.encode(b)  # [3, 40]
    idx = ratematch.conv_rm_indices(CODED, E_TOTAL)
    e = coded.reshape(-1)[idx]
    return (e ^ _scramble_seq(cell.cell_id)).astype(np.uint8)


def frame_symbols(cell: Cell, codeword: np.ndarray, quarter: int) -> np.ndarray:
    """The 240 QPSK symbols transmitted in radio frame (sfn mod 4 == quarter)."""
    chunk = codeword[quarter * E_FRAME : (quarter + 1) * E_FRAME]
    return modulation.modulate_np(chunk, 2)


def map_to_grid(cell: Cell, grid: np.ndarray, symbols: np.ndarray) -> None:
    pos = regrid.pbch_positions(cell)
    grid[pos[:, 0], pos[:, 1]] = symbols


def map_to_grid_tm2(cell: Cell, grids: list[np.ndarray],
                    symbols: np.ndarray) -> None:
    """2-port SFBC mapping of the PBCH block (36.211 §6.6.3: transmit
    diversity over consecutive REs in mapping order): port0 carries
    (x0, x1)/sqrt2, port1 (-x1*, x0*)/sqrt2 — the same convention
    equalize.alamouti_combine inverts."""
    from . import control

    pos = regrid.pbch_positions(cell)
    p0, p1 = control._sfbc_precode(symbols)
    grids[0][pos[:, 0], pos[:, 1]] = p0
    grids[1][pos[:, 0], pos[:, 1]] = p1


def extract_re(cell: Cell, grid: jnp.ndarray) -> jnp.ndarray:
    from ..utils.jaxutil import cgather

    pos = regrid.pbch_positions(cell)
    flat = grid.reshape(grid.shape[:-2] + (-1,))
    idx = pos[:, 0].astype(np.int64) * cell.n_sc + pos[:, 1]
    return cgather(flat, jnp.asarray(idx), axis=-1)


def decode(cell: Cell, x_eq: jnp.ndarray, nv_eff) -> tuple[Mib | None, int, int]:
    """Decode MIB from ONE equalized PBCH block (240 symbols).

    x_eq: [240] equalized symbols, nv_eff: per-RE noise. Tries all 4
    quarter offsets (batched Viterbi) x 3 port masks.
    Returns (mib | None, quarter, n_ports) — mirrors the bool + payload
    contract of ``srslte_pbch_decode`` at phch_recv.cc:207-227.
    """
    llr = modulation.demodulate_soft(x_eq, 2, nv_eff)  # [480]
    scr = jnp.asarray(
        (1.0 - 2.0 * _scramble_seq(cell.cell_id)).astype(np.float32)
    )
    idx = ratematch.conv_rm_indices(CODED, E_TOTAL)

    # batch the 4 quarter hypotheses: place the 480 observed LLRs at each
    # candidate offset of the 1920-length stream, dematch, decode.
    cands = []
    for q in range(4):
        full = jnp.zeros((E_TOTAL,), llr.dtype)
        seg = llr * scr[q * E_FRAME : (q + 1) * E_FRAME]
        full = full.at[q * E_FRAME : (q + 1) * E_FRAME].set(seg)
        d = ratematch.dematch(full, idx, 3 * CODED)
        cands.append(d.reshape(3, CODED).T)  # [CODED, 3]
    from ..utils.jaxutil import to_host

    hard = to_host(convcode.decode(jnp.stack(cands)))  # [4, CODED]

    for q in range(4):
        if not hard[q].any():
            # the all-zero codeword trivially satisfies CRC(0)=0 and is
            # what Viterbi emits for an empty/zero-energy PBCH region —
            # reject it (a real MIB with all-zero payload would still be
            # caught here; bandwidth code 0 + sfn 0 + phich 1/6 all-zero
            # is vanishingly unlikely vs. misalignment)
            continue
        for ports, mask in ANT_MASK.items():
            if crc.check(hard[q], "16", mask=mask):
                return unpack_mib(hard[q][:MIB_LEN], q), q, ports
    return None, -1, 0
