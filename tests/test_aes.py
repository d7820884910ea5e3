"""The in-repo AES-128 against the published test vectors: FIPS-197
(block cipher) and NIST SP 800-38A (CTR mode)."""

import pytest

from srsue_tpu.usim import security as sec


@pytest.mark.parametrize("key,plain,cipher", [
    # FIPS-197 Appendix C.1 (AES-128)
    ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
     "69c4e0d86a7b0430d8cdb78070b4c55a"),
    # FIPS-197 Appendix B (the cipher example)
    ("2b7e151628aed2a6abf7158809cf4f3c", "3243f6a8885a308d313198a2e0370734",
     "3925841d02dc09fbdc118597196a0b32"),
    # SP 800-38A F.1.1 (ECB-AES128), blocks 1 and 4
    ("2b7e151628aed2a6abf7158809cf4f3c", "6bc1bee22e409f96e93d7e117393172a",
     "3ad77bb40d7a3660a89ecaf32466ef97"),
    ("2b7e151628aed2a6abf7158809cf4f3c", "f69f2445df4f9b17ad2b417be66c3710",
     "7b0c785e27e8ad3f8223207104725dd4"),
])
def test_aes128_block_vectors(key, plain, cipher):
    got = sec._aes_ecb(bytes.fromhex(key), bytes.fromhex(plain))
    assert got.hex() == cipher


def test_aes128_key_schedule_fips197_a1():
    """FIPS-197 Appendix A.1: first and last round-key words."""
    w = sec._aes_key_schedule(bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"))
    assert len(w) == 44
    assert w[4] == 0xA0FAFE17
    assert w[43] == 0xB6630CA6


def test_aes128_ctr_sp800_38a_f51():
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    iv = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
    plain = bytes.fromhex(
        "6bc1bee22e409f96e93d7e117393172a"
        "ae2d8a571e03ac9c9eb76fac45af8e51"
        "30c81c46a35ce411e5fbc1191a0a52ef"
        "f69f2445df4f9b17ad2b417be66c3710")
    cipher = (
        "874d6191b620e3261bef6864990db6ce"
        "9806f66b7970fdff8617187bb9fffdff"
        "5ae4df3edbd5d35e5b4f09020db03eab"
        "1e031dda2fbe03d1792170a0f3009cee")
    assert sec.aes_ctr(key, iv, plain).hex() == cipher
    # a partial last block uses the keystream prefix; CTR is an involution
    assert sec.aes_ctr(key, iv, plain[:37]).hex() == cipher[:74]
    assert sec.aes_ctr(key, iv, bytes.fromhex(cipher)) == plain


def test_aes128_ctr_counter_wraps():
    key = bytes(16)
    top = bytes.fromhex("ff" * 16)
    two = sec.aes_ctr(key, top, bytes(32))
    assert two[:16] == sec._aes_ecb(key, top)
    assert two[16:] == sec._aes_ecb(key, bytes(16))


@pytest.mark.parametrize("key,block", [(bytes(15), bytes(16)),
                                       (bytes(16), bytes(17))])
def test_aes128_rejects_bad_lengths(key, block):
    with pytest.raises(ValueError):
        sec._aes_ecb(key, block)
