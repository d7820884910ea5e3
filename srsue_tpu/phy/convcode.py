"""Tail-biting convolutional code (36.212 §5.1.3.1) — encoder + batched
circular Viterbi decoder.

Used by PBCH (MIB), PDCCH (DCI) and PCFICH-adjacent control decoding; the
reference consumes this through srsLTE's Viterbi inside
``srslte_pbch_decode`` / ``srslte_pdcch_extract_llr`` + DCI blind search
(ue/src/phy/phch_recv.cc:96-264, ue/src/phy/phch_worker.cc:278-326).

Design
------
The decoder is a ``lax.scan`` over trellis steps with the 64 path metrics
and the batch axis laid out as a single [B, 64] f32 array — dense
add-compare-select with no data-dependent control flow. Blind DCI search
batches all (candidate location, aggregation, DCI-size) hypotheses in B,
so one decoder call covers the whole search space (SURVEY.md §7 hard
part 2). Tail-biting is handled with the circular ("wrap-around") Viterbi:
ACS over the sequence twice, traceback over the second pass.

Convention: state s = (x_{k-1}..x_{k-6}) as a 6-bit int, newest bit = MSB;
the 7-bit word w = x_k*64 + s indexes branches; next state = w >> 1.
LLR sign: positive = bit 0 (matches modulation.demodulate_soft).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

GENS = (0o133, 0o171, 0o165)
K = 7
NSTATES = 64


def _popcount_parity(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    for i in range(7):
        out ^= (x >> i) & 1
    return out


@functools.lru_cache(maxsize=1)
def _tables():
    """Precomputed trellis tables.

    out_pm1[w, j]: +-1 expected soft value (1-2*bit) of output stream j for
        branch word w in [0,128).
    prev[ns, t]: the two 7-bit branch words leading INTO next-state ns.
    """
    w = np.arange(128)
    outs = np.stack([_popcount_parity(w & g) for g in GENS], axis=1)  # [128,3]
    out_pm1 = (1.0 - 2.0 * outs).astype(np.float32)
    ns = np.arange(NSTATES)
    prev = np.stack([2 * ns, 2 * ns + 1], axis=1).astype(np.int32)  # [64,2]
    prev_state = prev & 63
    inp_bit = (np.arange(NSTATES) >> 5) & 1  # x_k = MSB of ns
    return out_pm1, prev, prev_state, inp_bit.astype(np.uint8)


def encode(bits: np.ndarray) -> np.ndarray:
    """Tail-biting encode: [n] {0,1} -> [3n] (d0[0],..  stream-major [3, n]
    flattened as streams concatenated: returns shape [3, n])."""
    b = np.asarray(bits, dtype=np.uint8).ravel()
    n = len(b)
    from ..utils import native

    nat = native.conv_encode(b)
    if nat is not None:
        return nat
    state = 0
    for i in range(6):  # init register with last 6 bits (tail-biting)
        state |= int(b[n - 1 - i]) << (5 - i)
    out = np.empty((3, n), dtype=np.uint8)
    out_tab, _, _, _ = _tables()
    for k in range(n):
        w = (int(b[k]) << 6) | state
        for j in range(3):
            out[j, k] = (1 - int(out_tab[w, j])) // 2
        state = w >> 1
    return out


def decode(llrs: jnp.ndarray) -> jnp.ndarray:
    """Batched circular Viterbi decode.

    llrs: [B, n, 3] float soft values (positive = bit 0) for the three
    output streams. Returns hard decisions [B, n] uint8.

    r5 restructure (bench: 6.5 -> ~1 ms at the blind-search shape,
    B=4608, n=44):

    * The trellis gathers are FREE: prev_state[ns, t] = (2*ns + t) & 63
      means pm[:, prev_state] is just concat(pm, pm) viewed as
      [B, 64, 2], and bm[:, prev] is bm viewed as [B, 64, 2] — pure
      reshapes, no gather lowering at all.
    * REGISTER-EXCHANGE survivors: each state carries its decoded bit
      history packed into int32 words, updated with the same
      concat-view select. This removes the [2n, B, 64] decision store
      AND the entire n-step traceback scan — the result is read
      directly from the winning state's registers.
    * The scan body processes CHUNK trellis steps (metric drift over a
      chunk is far below f32 resolution, so one normalization per
      chunk suffices) — CHUNK-fold fewer scan steps.
    """
    out_pm1, _, _, _ = _tables()
    out_pm1 = jnp.asarray(out_pm1)           # [128, 3]

    B, n, _ = llrs.shape
    n_words = -(-n // 32)  # packed survivor words per state
    # circular: two passes over the sequence; pad the FRONT so the total
    # step count is a CHUNK multiple (the pad steps see zero LLRs = no
    # metric information; they only warm the wrap-around state, which is
    # exactly what the first pass is for)
    # 2 trellis steps per scan iteration: LLVM code size grows with the
    # unrolled body, and the many per-shape Viterbi instances of one OTA
    # test were enough to exhaust XLA:CPU's executable code memory (r5:
    # segfault inside the compilation-cache load in test_ota_handover).
    CHUNK = 2
    total = 2 * n
    pad = (-total) % CHUNK
    llr2 = jnp.concatenate(
        [jnp.zeros((B, pad, 3), llrs.dtype), llrs, llrs], axis=1)

    def one_step(pm, surv, llr_k):
        # branch metrics for all 128 words: [B, 128]
        bm = jnp.matmul(llr_k, out_pm1.T, precision=jax.lax.Precision.HIGHEST)
        # candidates via the concat view: cand[:, ns, t] =
        # pm[:, (2ns+t) & 63] + bm[:, 2ns+t]
        pmpm = jnp.concatenate([pm, pm], axis=-1).reshape(B, NSTATES, 2)
        cand = pmpm + bm.reshape(B, NSTATES, 2)
        take1 = cand[..., 1] > cand[..., 0]  # [B, 64]
        pm_next = jnp.where(take1, cand[..., 1], cand[..., 0])
        # survivor register exchange: winner's history, shifted, newest
        # decoded input bit (MSB of the next state) appended at the LSB
        bit = jnp.asarray((np.arange(NSTATES) >> 5) & 1, jnp.int32)
        new_surv = []
        carry_in = jnp.broadcast_to(bit, (B, NSTATES))
        for w in range(n_words):  # low word first; bit31 carries upward
            svv = jnp.concatenate([surv[w], surv[w]], axis=-1).reshape(
                B, NSTATES, 2)
            chosen = jnp.where(take1, svv[..., 1], svv[..., 0])
            new_surv.append((chosen << 1) | carry_in)
            carry_in = (chosen >> 31) & 1
        return pm_next, new_surv

    def chunk_step(carry, llr_c):
        pm, surv = carry
        for j in range(CHUNK):
            pm, surv = one_step(pm, surv, llr_c[j])
        pm = pm - jnp.max(pm, axis=-1, keepdims=True)
        return (pm, surv), None

    pm0 = jnp.zeros((B, NSTATES), dtype=jnp.float32)
    surv0 = [jnp.zeros((B, NSTATES), jnp.int32) for _ in range(n_words)]
    xs = jnp.swapaxes(llr2, 0, 1).reshape(-1, CHUNK, B, 3)
    (pm, surv), _ = jax.lax.scan(chunk_step, (pm0, surv0), xs)

    # read the decoded window straight out of the winning state's
    # registers: bit k (k = 0..n-1, oldest first) is at packed position
    # n-1-k from the LSB end
    best = jnp.argmax(pm, axis=-1)[:, None]  # [B, 1]
    words = [jnp.take_along_axis(s, best, axis=1)[:, 0] for s in surv]
    pos = (n - 1) - jnp.arange(n)  # LSB offset of bit k
    word_i = pos // 32
    bit_i = pos % 32
    stackw = jnp.stack(words, axis=-1)  # [B, n_words]
    sel = jnp.take_along_axis(
        stackw, jnp.broadcast_to(word_i[None, :], (B, n)), axis=1)
    return ((sel >> bit_i[None, :]) & 1).astype(jnp.uint8)


def encode_jax(bits: jnp.ndarray) -> jnp.ndarray:
    """Batched tail-biting encoder in JAX (eNB-side vector generation on
    device): [B, n] -> [B, 3, n]."""
    out_tab, _, _, _ = _tables()
    bits_tab = ((1 - out_tab) / 2).astype(np.uint8)  # [128,3] output bits
    bits_tab_j = jnp.asarray(bits_tab)
    B, n = bits.shape
    b = bits.astype(jnp.int32)
    init_state = jnp.zeros((B,), jnp.int32)
    for i in range(6):
        init_state = init_state | (b[:, n - 1 - i] << (5 - i))

    def step(state, bk):
        w = (bk << 6) | state
        return w >> 1, bits_tab_j[w]  # [B, 3]

    _, outs = jax.lax.scan(step, init_state, jnp.swapaxes(b, 0, 1))
    return jnp.transpose(outs, (1, 2, 0))  # [B, 3, n]
