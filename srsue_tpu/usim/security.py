"""LTE security primitives — 33.401/35.206 (reference:
liblte/src/liblte_security.cc:257-560).

* KDF: HMAC-SHA256 key derivation (K_ASME, K_eNB, K_NAS/K_RRC/K_UP).
* 128-EIA2: AES-CMAC integrity (NIST SP 800-38B over the EIA2 framing).
* 128-EEA2: AES-CTR ciphering; EEA0 = null cipher.
* Milenage: f1/f1*/f2/f3/f4/f5/f5* on AES-128 (35.206).

AES-128 core (FIPS-197, encryption direction only, which is all that
CMAC, CTR and Milenage use) in this module: the reference's polarssl
role, with no third-party dependency.
"""

from __future__ import annotations

import functools
import hmac
import hashlib


# ---------------------------------------------------------------------------
# AES-128 — FIPS-197 (T-table form: one table lookup per byte and round)
# ---------------------------------------------------------------------------


def _aes_tables():
    exp = [0] * 512  # GF(2^8) antilog over generator 3, doubled for mod-free
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = exp[i + 255] = x
        log[x] = i
        x ^= (x << 1) ^ (0x11B if x & 0x80 else 0)  # x *= 3
    sbox = [0] * 256
    for a in range(256):
        inv = exp[255 - log[a]] if a else 0
        b = inv
        for r in range(1, 5):
            b ^= ((inv << r) | (inv >> (8 - r))) & 0xFF
        sbox[a] = b ^ 0x63

    def mul(a, c):
        return exp[log[a] + log[c]] if a and c else 0

    te = [[0] * 256 for _ in range(4)]
    for a in range(256):
        s_ = sbox[a]
        w = (mul(s_, 2) << 24) | (s_ << 16) | (s_ << 8) | mul(s_, 3)
        for j in range(4):  # Te_j = Te_0 rotated right by 8*j bits
            te[j][a] = ((w >> (8 * j)) | (w << (32 - 8 * j))) & 0xFFFFFFFF
    return sbox, te


_SBOX, _TE = _aes_tables()


@functools.lru_cache(maxsize=64)
def _aes_key_schedule(key: bytes) -> tuple[int, ...]:
    """44 round-key words of AES-128 (FIPS-197 §5.2)."""
    if len(key) != 16:
        raise ValueError(f"AES-128 key must be 16 bytes, got {len(key)}")
    w = [int.from_bytes(key[4 * i : 4 * i + 4], "big") for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = w[i - 1]
        if i % 4 == 0:
            t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF
            t = ((_SBOX[t >> 24] << 24) | (_SBOX[(t >> 16) & 0xFF] << 16)
                 | (_SBOX[(t >> 8) & 0xFF] << 8) | _SBOX[t & 0xFF])
            t ^= rcon << 24
            rcon = (rcon << 1) ^ (0x11B if rcon & 0x80 else 0)
        w.append(w[i - 4] ^ t)
    return tuple(w)


def _aes_ecb(key: bytes, block: bytes) -> bytes:
    """AES-128 encryption of one 16-byte block."""
    if len(block) != 16:
        raise ValueError(f"AES block must be 16 bytes, got {len(block)}")
    rk = _aes_key_schedule(bytes(key))
    t0, t1, t2, t3 = _TE
    s = [int.from_bytes(block[4 * i : 4 * i + 4], "big") ^ rk[i]
         for i in range(4)]
    for r in range(1, 10):
        s = [t0[s[c] >> 24] ^ t1[(s[(c + 1) % 4] >> 16) & 0xFF]
             ^ t2[(s[(c + 2) % 4] >> 8) & 0xFF] ^ t3[s[(c + 3) % 4] & 0xFF]
             ^ rk[4 * r + c] for c in range(4)]
    sb = _SBOX
    out = b""
    for c in range(4):
        v = ((sb[s[c] >> 24] << 24) | (sb[(s[(c + 1) % 4] >> 16) & 0xFF] << 16)
             | (sb[(s[(c + 2) % 4] >> 8) & 0xFF] << 8)
             | sb[s[(c + 3) % 4] & 0xFF]) ^ rk[40 + c]
        out += v.to_bytes(4, "big")
    return out


def aes_ctr(key: bytes, iv: bytes, msg: bytes) -> bytes:
    """AES-128 in counter mode (SP 800-38A): the 128-bit counter block
    starts at `iv` and increments big-endian modulo 2^128."""
    ctr = int.from_bytes(iv, "big")
    out = bytearray(len(msg))
    for off in range(0, len(msg), 16):
        ks = _aes_ecb(key, ctr.to_bytes(16, "big"))
        chunk = msg[off : off + 16]
        out[off : off + len(chunk)] = bytes(a ^ b for a, b in zip(chunk, ks))
        ctr = (ctr + 1) & ((1 << 128) - 1)
    return bytes(out)


# ---------------------------------------------------------------------------
# KDF — 33.401 Annex A
# ---------------------------------------------------------------------------


def kdf(key: bytes, fc: int, *params: bytes) -> bytes:
    s = bytes([fc])
    for p in params:
        s += p + len(p).to_bytes(2, "big")
    return hmac.new(key, s, hashlib.sha256).digest()


def kdf_k_asme(ck: bytes, ik: bytes, plmn: bytes, sqn_xor_ak: bytes) -> bytes:
    """A.2: K_ASME from CK||IK, SN id (3 bytes), SQN^AK (6 bytes)."""
    return kdf(ck + ik, 0x10, plmn, sqn_xor_ak)


def kdf_k_enb(k_asme: bytes, nas_count: int) -> bytes:
    return kdf(k_asme, 0x11, nas_count.to_bytes(4, "big"))


def kdf_nh(k_asme: bytes, sync_input: bytes) -> bytes:
    """A.4: NH derivation. sync_input = initial K_eNB for NH(1), the
    previous NH for NH(i>1) — the vertical key-chaining input used at
    handover/re-establishment (33.401 §7.2.8)."""
    return kdf(k_asme, 0x12, sync_input)


def kdf_k_enb_star(key: bytes, pci: int, earfcn_dl: int) -> bytes:
    """A.5: K_eNB* from current K_eNB (horizontal, NCC unchanged) or NH
    (vertical, NCC increased) + target PCI + DL EARFCN."""
    return kdf(key, 0x13, pci.to_bytes(2, "big"), earfcn_dl.to_bytes(2, "big"))


def kdf_nas(k_asme: bytes, alg_id: int, is_integrity: bool) -> bytes:
    dist = 0x02 if is_integrity else 0x01
    return kdf(k_asme, 0x15, bytes([dist]), bytes([alg_id]))[16:]


def kdf_as(k_enb: bytes, alg_id: int, kind: str) -> bytes:
    """kind in {'rrc_enc','rrc_int','up_enc','up_int'} (A.7)."""
    dist = {"up_enc": 0x03, "up_int": 0x04, "rrc_enc": 0x05, "rrc_int": 0x06}[kind]
    return kdf(k_enb, 0x15, bytes([dist]), bytes([alg_id]))[16:]


# ---------------------------------------------------------------------------
# AES-CMAC (SP 800-38B) + 128-EIA2
# ---------------------------------------------------------------------------


def _leftshift(b: bytes) -> bytes:
    n = int.from_bytes(b, "big") << 1
    return (n & ((1 << 128) - 1)).to_bytes(16, "big"), (n >> 128) & 1


def _cmac_subkeys(key: bytes) -> tuple[bytes, bytes]:
    l = _aes_ecb(key, b"\x00" * 16)
    k1, ov = _leftshift(l)
    if ov:
        k1 = (int.from_bytes(k1, "big") ^ 0x87).to_bytes(16, "big")
    k2, ov = _leftshift(k1)
    if ov:
        k2 = (int.from_bytes(k2, "big") ^ 0x87).to_bytes(16, "big")
    return k1, k2


def aes_cmac(key: bytes, msg: bytes) -> bytes:
    k1, k2 = _cmac_subkeys(key)
    n = max(1, (len(msg) + 15) // 16)
    complete = len(msg) > 0 and len(msg) % 16 == 0
    blocks = [msg[i * 16 : (i + 1) * 16] for i in range(n)]
    last = blocks[-1]
    if complete:
        last = bytes(a ^ b for a, b in zip(last, k1))
    else:
        pad = last + b"\x80" + b"\x00" * (15 - len(last))
        last = bytes(a ^ b for a, b in zip(pad, k2))
    x = b"\x00" * 16
    for blk in blocks[:-1]:
        x = _aes_ecb(key, bytes(a ^ b for a, b in zip(x, blk)))
    return _aes_ecb(key, bytes(a ^ b for a, b in zip(x, last)))


def eia2(key: bytes, count: int, bearer: int, direction: int, msg: bytes) -> bytes:
    """128-EIA2 MAC-I (4 bytes)."""
    m = count.to_bytes(4, "big") + bytes([(bearer << 3) | (direction << 2)]) + b"\x00" * 3 + msg
    return aes_cmac(key, m)[:4]


def eea2(key: bytes, count: int, bearer: int, direction: int, msg: bytes) -> bytes:
    """128-EEA2 AES-CTR cipher (encrypt == decrypt)."""
    iv = count.to_bytes(4, "big") + bytes([(bearer << 3) | (direction << 2)]) + b"\x00" * 11
    return aes_ctr(key, iv, msg)


def eea0(key: bytes, count: int, bearer: int, direction: int, msg: bytes) -> bytes:
    """Null ciphering (the reference's configured algorithm, rrc.cc:493-496)."""
    return bytes(msg)


EIA = {1: None, 2: eia2}  # EIA1 (SNOW) flagged unsupported
EEA = {0: eea0, 2: eea2}


# ---------------------------------------------------------------------------
# Milenage — 35.206 §4
# ---------------------------------------------------------------------------


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def _rot(b: bytes, r_bits: int) -> bytes:
    n = int.from_bytes(b, "big")
    n = ((n << r_bits) | (n >> (128 - r_bits))) & ((1 << 128) - 1)
    return n.to_bytes(16, "big")


def milenage_opc(k: bytes, op: bytes) -> bytes:
    return _xor(_aes_ecb(k, op), op)


def milenage_f1(k: bytes, opc: bytes, rand: bytes, sqn: bytes, amf: bytes):
    """Returns (mac_a, mac_s)."""
    temp = _aes_ecb(k, _xor(rand, opc))
    in1 = sqn + amf + sqn + amf
    out1 = _xor(
        _aes_ecb(k, _xor(_rot(_xor(in1, opc), 64), temp)), opc
    )
    return out1[:8], out1[8:]


def milenage_f2345(k: bytes, opc: bytes, rand: bytes):
    """Returns (res, ck, ik, ak)."""
    temp = _aes_ecb(k, _xor(rand, opc))
    # OUT2 = E[rot(temp^OPc, r2) ^ c2]K ^ OPc ; c2 = ...1, r2=0
    c2 = (1).to_bytes(16, "big")
    out2 = _xor(_aes_ecb(k, _xor(_xor(temp, opc), c2)), opc)
    res = out2[8:]
    ak = out2[:6]
    c3 = (2).to_bytes(16, "big")
    out3 = _xor(_aes_ecb(k, _xor(_rot(_xor(temp, opc), 32), c3)), opc)
    ck = out3
    c4 = (4).to_bytes(16, "big")
    out4 = _xor(_aes_ecb(k, _xor(_rot(_xor(temp, opc), 64), c4)), opc)
    ik = out4
    return res, ck, ik, ak


def milenage_f5_star(k: bytes, opc: bytes, rand: bytes) -> bytes:
    temp = _aes_ecb(k, _xor(rand, opc))
    c5 = (8).to_bytes(16, "big")
    out5 = _xor(_aes_ecb(k, _xor(_rot(_xor(temp, opc), 96), c5)), opc)
    return out5[:6]
