"""LTE turbo codec — 36.212 §5.1.3.2: rate-1/3 PCCC with QPP interleaver,
encoder + batched max-log-MAP (BCJR) decoder.

This is the dominant DL hot loop (SURVEY.md §3.2 "DSP hot loop 2"); the
reference hits it through ``srslte_pdsch_decode_rnti`` with SSE/AVX
SIMD (>100 Mbps, README.md:18). Design:

* Code blocks are batched on the leading axis, so every
  add-compare-select is one dense [B, 8]-shaped array op.
* Forward/backward recursions are ``lax.scan``s over the trellis, split
  into windows that run in parallel (``_bcjr_half_windowed``). On a GPU
  ``turbo_pallas`` replaces that half-iteration with one fused kernel;
  the iteration loop, interleaving and CRC early exit below are shared.
* The QPP interleave/deinterleave is a device gather with host-cached
  index tables per block size K.

Constituent RSC: g0 = 1+D^2+D^3 (feedback), g1 = 1+D+D^3. Each encoder is
trellis-terminated with 3 tail steps (12 tail bits total, multiplexed per
the spec into the three length-(K+4) output streams).

LLR convention: positive = bit 0 (consistent with modulation/convcode).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# --- QPP interleaver table: 36.212 Table 5.1.3-3 (K, f1, f2) ---------------
QPP_TABLE: dict[int, tuple[int, int]] = {
    40: (3, 10), 48: (7, 12), 56: (19, 42), 64: (7, 16), 72: (7, 18),
    80: (11, 20), 88: (5, 22), 96: (11, 24), 104: (7, 26), 112: (41, 84),
    120: (103, 90), 128: (15, 32), 136: (9, 34), 144: (17, 108), 152: (9, 38),
    160: (21, 120), 168: (101, 84), 176: (21, 44), 184: (57, 46), 192: (23, 48),
    200: (13, 50), 208: (27, 52), 216: (11, 36), 224: (27, 56), 232: (85, 58),
    240: (29, 60), 248: (33, 62), 256: (15, 32), 264: (17, 198), 272: (33, 68),
    280: (103, 210), 288: (19, 36), 296: (19, 74), 304: (37, 76), 312: (19, 78),
    320: (21, 120), 328: (21, 82), 336: (115, 84), 344: (193, 86), 352: (21, 44),
    360: (133, 90), 368: (81, 46), 376: (45, 94), 384: (23, 48), 392: (243, 98),
    400: (151, 40), 408: (155, 102), 416: (25, 52), 424: (51, 106), 432: (47, 72),
    440: (91, 110), 448: (29, 168), 456: (29, 114), 464: (247, 58), 472: (29, 118),
    480: (89, 180), 488: (91, 122), 496: (157, 62), 504: (55, 84), 512: (31, 64),
    528: (17, 66), 544: (35, 68), 560: (227, 420), 576: (65, 96), 592: (19, 74),
    608: (37, 76), 624: (41, 234), 640: (39, 80), 656: (185, 82), 672: (43, 252),
    688: (21, 86), 704: (155, 44), 720: (79, 120), 736: (139, 92), 752: (23, 94),
    768: (217, 48), 784: (25, 98), 800: (17, 80), 816: (127, 102), 832: (25, 52),
    848: (239, 106), 864: (17, 48), 880: (137, 110), 896: (215, 112),
    912: (29, 114), 928: (15, 58), 944: (147, 118), 960: (29, 60), 976: (59, 122),
    992: (65, 124), 1008: (55, 84), 1024: (31, 64), 1056: (17, 66),
    1088: (171, 204), 1120: (67, 140), 1152: (35, 72), 1184: (19, 74),
    1216: (39, 76), 1248: (19, 78), 1280: (199, 240), 1312: (21, 82),
    1344: (211, 252), 1376: (21, 86), 1408: (43, 88), 1440: (149, 60),
    1472: (45, 92), 1504: (49, 846), 1536: (71, 48), 1568: (13, 28),
    1600: (17, 80), 1632: (25, 102), 1664: (183, 104), 1696: (55, 954),
    1728: (127, 96), 1760: (27, 110), 1792: (29, 112), 1824: (29, 114),
    1856: (57, 116), 1888: (45, 354), 1920: (31, 120), 1952: (59, 610),
    1984: (185, 124), 2016: (113, 420), 2048: (31, 64), 2112: (17, 66),
    2176: (171, 136), 2240: (209, 420), 2304: (253, 216), 2368: (367, 444),
    2432: (265, 456), 2496: (181, 468), 2560: (39, 80), 2624: (27, 164),
    2688: (127, 504), 2752: (143, 172), 2816: (43, 88), 2880: (29, 300),
    2944: (45, 92), 3008: (157, 188), 3072: (47, 96), 3136: (13, 28),
    3200: (111, 240), 3264: (443, 204), 3328: (51, 104), 3392: (51, 212),
    3456: (451, 192), 3520: (257, 220), 3584: (57, 336), 3648: (313, 228),
    3712: (271, 232), 3776: (179, 236), 3840: (331, 120), 3904: (363, 244),
    3968: (375, 248), 4032: (127, 168), 4096: (31, 64), 4160: (33, 130),
    4224: (43, 264), 4288: (33, 134), 4352: (477, 408), 4416: (35, 138),
    4480: (233, 280), 4544: (357, 142), 4608: (337, 480), 4672: (37, 146),
    4736: (71, 444), 4800: (71, 120), 4864: (37, 152), 4928: (39, 462),
    4992: (127, 234), 5056: (39, 158), 5120: (39, 80), 5184: (31, 96),
    5248: (113, 902), 5312: (41, 166), 5376: (251, 336), 5440: (43, 170),
    5504: (21, 86), 5568: (43, 174), 5632: (45, 176), 5696: (45, 178),
    5760: (161, 120), 5824: (89, 182), 5888: (323, 184), 5952: (47, 186),
    6016: (23, 94), 6080: (47, 190), 6144: (263, 480),
}

VALID_K = np.array(sorted(QPP_TABLE), dtype=np.int64)
MAX_K = 6144


@functools.lru_cache(maxsize=256)
def qpp_perm(k: int) -> np.ndarray:
    """pi(i) = (f1*i + f2*i^2) mod K. x'_i = x_{pi(i)} feeds encoder 2."""
    f1, f2 = QPP_TABLE[k]
    i = np.arange(k, dtype=np.int64)
    return (f1 * i + f2 * i * i) % k


@functools.lru_cache(maxsize=256)
def qpp_inv(k: int) -> np.ndarray:
    p = qpp_perm(k)
    inv = np.empty_like(p)
    inv[p] = np.arange(k)
    return inv


# --- RSC trellis tables -----------------------------------------------------
# state = (s2 s1 s0) = registers D1 D2 D3; feedback f = s1 ^ s2 (D^2+D^3);
# with input u: reg_in = u ^ f; parity = reg_in ^ s0 ^ s2 (1 + D + D^3 taps
# applied to [reg_in, s0(D), s1(D^2), s2(D^3)]... see _build_trellis.


@functools.lru_cache(maxsize=1)
def _trellis():
    """Returns (next_state[8,2], parity[8,2], term_bit[8,3-step path]).

    Register convention: state bits (r1, r2, r3) with r1 newest.
    Feedback g0 = 1 + D^2 + D^3: f = r2 ^ r3.
    Input to register chain: a = u ^ f.
    Parity g1 = 1 + D + D^3 over [a, r1, r2, r3] taps (1, D, D^3):
    p = a ^ r1 ^ r3.
    Next state: (a, r1, r2).
    """
    ns = np.zeros((8, 2), np.int32)
    par = np.zeros((8, 2), np.int32)
    for s in range(8):
        r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        f = r2 ^ r3
        for u in (0, 1):
            a = u ^ f
            p = a ^ r1 ^ r3
            ns[s, u] = (a << 2) | (r1 << 1) | r2
            par[s, u] = p
    # termination input (u = f) per state: drives register to zero in 3 steps
    term_u = np.zeros(8, np.int32)
    for s in range(8):
        r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        term_u[s] = r2 ^ r3
    return ns, par, term_u


def _rsc_encode(bits: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode one block with one RSC: returns (parity[k], tail_sys[3],
    tail_par[3]) — systematic output is the input itself."""
    ns, par, _ = _trellis()
    s = 0
    k = len(bits)
    p = np.empty(k, np.uint8)
    for i in range(k):
        u = int(bits[i])
        p[i] = par[s, u]
        s = ns[s, u]
    tail_sys = np.empty(3, np.uint8)
    tail_par = np.empty(3, np.uint8)
    for i in range(3):
        r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        u = r2 ^ r3  # feedback-cancelling input terminates the trellis
        tail_sys[i] = u
        tail_par[i] = par[s, u]
        s = ns[s, u]
    assert s == 0
    return p, tail_sys, tail_par


def encode(bits: np.ndarray) -> np.ndarray:
    """Turbo-encode one code block: [K] {0,1} -> d streams [3, K+4].

    Tail multiplexing per 36.212 §5.1.3.2.2:
      d0: x_1..x_K, x_K+1, z_K+2, x'_K+1, z'_K+2
      d1: z_1..z_K, z_K+1, x_K+3, z'_K+1, x'_K+3
      d2: x'(pi)...: z'_1..z'_K? — No: d2 carries encoder-2 parity z'.
      (x = systematic, z = parity1, x'/z' = enc-2 tail sys/parity.)
    """
    b = np.asarray(bits, np.uint8).ravel()
    k = len(b)
    assert k in QPP_TABLE, f"invalid turbo K={k}"
    perm = qpp_perm(k)
    from ..utils import native

    nat = native.turbo_encode(b, perm)
    if nat is not None:
        return nat
    z1, t1x, t1z = _rsc_encode(b)
    z2, t2x, t2z = _rsc_encode(b[perm])
    d = np.zeros((3, k + 4), np.uint8)
    d[0, :k] = b
    d[1, :k] = z1
    d[2, :k] = z2
    # tail mux (36.212 §5.1.3.2.2): e_k sequence
    d[0, k + 0] = t1x[0]; d[1, k + 0] = t1z[0]; d[2, k + 0] = t1x[1]
    d[0, k + 1] = t1z[1]; d[1, k + 1] = t1x[2]; d[2, k + 1] = t1z[2]
    d[0, k + 2] = t2x[0]; d[1, k + 2] = t2z[0]; d[2, k + 2] = t2x[1]
    d[0, k + 3] = t2z[1]; d[1, k + 3] = t2x[2]; d[2, k + 3] = t2z[2]
    return d


# ---------------------------------------------------------------------------
# Max-log-MAP decoder (batched, lax.scan BCJR)
# ---------------------------------------------------------------------------

_NEG = -1e9


def _prev_tables():
    ns_np, par_np, _ = _trellis()
    prev_pairs = np.zeros((8, 2, 2), np.int32)
    cnt = [0] * 8
    for s in range(8):
        for u in (0, 1):
            n = ns_np[s, u]
            prev_pairs[n, cnt[n]] = (s, u)
            cnt[n] += 1
    return prev_pairs[:, :, 0], prev_pairs[:, :, 1]


def _tail_beta(tail_sys, tail_par, B):
    """Fold the 3 termination steps into the beta at step K."""
    ns_np, par_np, _ = _trellis()
    ns = jnp.asarray(ns_np)
    par_sign = jnp.asarray(1.0 - 2.0 * par_np.astype(np.float32))
    u_sign = jnp.asarray(np.array([1.0, -1.0], np.float32))
    beta_tail = jnp.full((B, 8), _NEG, jnp.float32).at[:, 0].set(0.0)
    for i in range(2, -1, -1):
        g = (
            0.5 * tail_sys[:, i][:, None, None] * u_sign[None, None, :]
            + 0.5 * tail_par[:, i][:, None, None] * par_sign[None, :, :]
        )
        cand = beta_tail[:, ns] + g
        beta_tail = jnp.max(cand, axis=-1)
        beta_tail = beta_tail - jnp.max(beta_tail, axis=-1, keepdims=True)
    return beta_tail


def _bcjr_half_windowed(sys_llr, par_llr, apriori, tail_sys, tail_par,
                        alpha_b, beta_b, lw: int):
    """Windowed max-log-MAP half-iteration.

    The K-step forward/backward recursions are split into W = K/lw
    windows that run in parallel (the scan length drops from K to lw —
    the classic windowed BCJR with next-iteration initialization: window
    boundary metrics are carried across turbo iterations via
    alpha_b/beta_b [B, W, 8]).

    Returns (extrinsic [B, K], new_alpha_b, new_beta_b).
    """
    ns_np, par_np, _ = _trellis()
    B, K = sys_llr.shape
    W = K // lw
    prev_s_np, prev_u_np = _prev_tables()
    prev_s = jnp.asarray(prev_s_np)
    prev_u = jnp.asarray(prev_u_np)
    ns = jnp.asarray(ns_np)
    par_sign = jnp.asarray(1.0 - 2.0 * par_np.astype(np.float32))
    u_sign = jnp.asarray(np.array([1.0, -1.0], np.float32))

    Lin = sys_llr + apriori
    lin_w = Lin.reshape(B, W, lw)
    par_w = par_llr.reshape(B, W, lw)

    def gamma_k(lin_k, lp_k):
        # [B, W, 8, 2]
        return (
            0.5 * lin_k[..., None, None] * u_sign
            + 0.5 * lp_k[..., None, None] * par_sign
        )

    a0, b0 = _window_inits(alpha_b, beta_b, tail_sys, tail_par)

    def fwd(alpha, x):
        lin_k, lp_k = x  # [B, W]
        g = gamma_k(lin_k, lp_k)
        cand = alpha[..., prev_s] + g[..., prev_s, prev_u]
        a_next = jnp.max(cand, axis=-1)
        a_next = a_next - jnp.max(a_next, axis=-1, keepdims=True)
        return a_next, alpha

    xs = (jnp.moveaxis(lin_w, 2, 0), jnp.moveaxis(par_w, 2, 0))
    alpha_last, alphas = jax.lax.scan(fwd, a0, xs)
    alphas = jnp.moveaxis(alphas, 0, 2)  # [B, W, lw, 8]

    def bwd(beta, x):
        lin_k, lp_k = x
        g = gamma_k(lin_k, lp_k)
        m = beta[..., ns] + g  # [B, W, 8, 2]
        beta_prev = jnp.max(m, axis=-1)
        beta_prev = beta_prev - jnp.max(beta_prev, axis=-1, keepdims=True)
        return beta_prev, m

    xs_rev = (jnp.moveaxis(lin_w, 2, 0)[::-1], jnp.moveaxis(par_w, 2, 0)[::-1])
    beta_first, ms = jax.lax.scan(bwd, b0, xs_rev)
    ms = jnp.moveaxis(ms[::-1], 0, 2)  # [B, W, lw, 8, 2]

    full = alphas[..., None] + ms
    l0 = jnp.max(full[..., 0], axis=-1)
    l1 = jnp.max(full[..., 1], axis=-1)
    post = (l0 - l1).reshape(B, K)
    return (post - Lin,) + _chain_boundaries(alpha_last, beta_first)


def _window_inits(alpha_b, beta_b, tail_sys, tail_par):
    """Initial alpha/beta [B, W, 8] of every window: window 0 starts in
    state 0 and window W-1 from the trellis termination (both exact);
    the others from the boundaries carried from the previous iteration."""
    B, W, _ = alpha_b.shape
    w = jnp.arange(W)[None, :, None]
    known0 = jnp.full((8,), _NEG, jnp.float32).at[0].set(0.0)
    a0 = jnp.where(w == 0, known0, alpha_b)
    b0 = jnp.where(w == W - 1,
                   _tail_beta(tail_sys, tail_par, B)[:, None, :], beta_b)
    return a0, b0


def _chain_boundaries(alpha_last, beta_first):
    """Next-iteration initialisation: window w starts from this
    iteration's final alpha of window w-1 and final beta of window w+1."""
    z = jnp.zeros_like(alpha_last[:, :1])
    return (jnp.concatenate([z, alpha_last[:, :-1]], axis=1),
            jnp.concatenate([beta_first[:, 1:], z], axis=1))


def _bcjr_half(sys_llr, par_llr, apriori, tail_sys, tail_par):
    """One constituent max-log-MAP pass.

    sys_llr/par_llr/apriori: [B, K]; tail_sys/tail_par: [B, 3].
    Returns extrinsic [B, K].
    """
    ns_np, par_np, _ = _trellis()
    B, K = sys_llr.shape

    # Per-step branch metrics for (state, u): gamma[b, s, u]
    # metric contribution: 0.5*L*(1-2bit) for sys(+apriori) and parity.
    Lin = sys_llr + apriori  # [B, K]
    par_sign = jnp.asarray(1.0 - 2.0 * par_np.astype(np.float32))  # [8,2]
    u_sign = jnp.asarray(np.array([1.0, -1.0], np.float32))  # bit 0 -> +

    ns = jnp.asarray(ns_np)  # [8,2]

    # previous-state table for backward/alpha indexing: for alpha we need,
    # for each next state, its (prev_state, u) pairs.
    prev_pairs = np.zeros((8, 2, 2), np.int32)  # [ns, j] -> (s, u)
    cnt = [0] * 8
    for s in range(8):
        for u in (0, 1):
            n = ns_np[s, u]
            prev_pairs[n, cnt[n]] = (s, u)
            cnt[n] += 1
    assert all(c == 2 for c in cnt)
    prev_s = jnp.asarray(prev_pairs[:, :, 0])  # [8,2]
    prev_u = jnp.asarray(prev_pairs[:, :, 1])  # [8,2]

    def gamma_k(lin_k, lp_k):
        # [B, 8, 2]
        g_sys = 0.5 * lin_k[:, None, None] * u_sign[None, None, :]
        g_par = 0.5 * lp_k[:, None, None] * par_sign[None, :, :]
        return g_sys + g_par

    # --- forward (alpha) over K data steps ---
    def fwd(alpha, x):
        lin_k, lp_k = x
        g = gamma_k(lin_k, lp_k)  # [B,8,2]
        # alpha_next[n] = max_j alpha[prev_s[n,j]] + g[prev_s[n,j], prev_u[n,j]]
        cand = alpha[:, prev_s] + g[:, prev_s, prev_u]  # [B,8,2]
        a_next = jnp.max(cand, axis=-1)
        a_next = a_next - jnp.max(a_next, axis=-1, keepdims=True)
        return a_next, alpha

    alpha0 = jnp.full((B, 8), _NEG, jnp.float32).at[:, 0].set(0.0)
    xs = (jnp.swapaxes(Lin, 0, 1), jnp.swapaxes(par_llr, 0, 1))
    _, alphas = jax.lax.scan(fwd, alpha0, xs)  # alphas[k] = alpha BEFORE step k
    alphas = jnp.swapaxes(alphas, 0, 1)  # [B, K, 8]

    # --- tail: fold 3 termination steps into beta init ---
    # beta_{K+3}: terminated state 0 only.
    beta_tail = jnp.full((B, 8), _NEG, jnp.float32).at[:, 0].set(0.0)
    for i in range(2, -1, -1):
        g_sys = 0.5 * tail_sys[:, i][:, None, None] * u_sign[None, None, :]
        g_par = 0.5 * tail_par[:, i][:, None, None] * par_sign[None, :, :]
        g = g_sys + g_par  # [B,8,2]
        cand = beta_tail[:, ns] + g  # [B,8,2]
        beta_tail = jnp.max(cand, axis=-1)
        beta_tail = beta_tail - jnp.max(beta_tail, axis=-1, keepdims=True)

    # --- backward (beta) + extrinsic in one scan ---
    def bwd(beta, x):
        lin_k, lp_k = x
        g = gamma_k(lin_k, lp_k)  # [B,8,2]
        m = beta[:, ns] + g  # [B,8,2] metric of (s,u) to end
        # beta_prev[s] = max_u m[s,u]
        beta_prev = jnp.max(m, axis=-1)
        beta_prev = beta_prev - jnp.max(beta_prev, axis=-1, keepdims=True)
        return beta_prev, m

    xs_rev = (jnp.swapaxes(Lin, 0, 1)[::-1], jnp.swapaxes(par_llr, 0, 1)[::-1])
    _, ms = jax.lax.scan(bwd, beta_tail, xs_rev)
    ms = jnp.swapaxes(ms[::-1], 0, 1)  # [B, K, 8, 2] = gamma + beta_next

    full = alphas[..., None] + ms  # [B, K, 8, 2]
    l0 = jnp.max(full[..., 0], axis=-1)
    l1 = jnp.max(full[..., 1], axis=-1)
    post = l0 - l1  # full posterior LLR (positive = bit 0)
    return post - Lin  # extrinsic


def pick_window(k: int, target: int = 64) -> int | None:
    """A window length that divides K, or None for small blocks where the
    plain full-length scan is fine."""
    if k <= 256:
        return None
    for lw in (target, 96, 128, 48, 32, 192, 256):
        if k % lw == 0 and k // lw >= 2:
            return lw
    return None


def decode(
    d_llrs: jnp.ndarray,
    k: int,
    n_iters: int = 8,
    crc_mat: np.ndarray | None = None,
    crc_len: int = 24,
    window: int | None = None,
    auto_window: bool = True,
    early_exit: bool = True,
    half=None,
):
    """Batched turbo decode.

    d_llrs: [B, 3, K+4] rate-dematched LLRs (streams d0=sys, d1=par1,
        d2=par2 with the spec tail multiplexing).
    Returns (hard_bits [B, K] uint8, n_iters_used [B] int32, crc_ok [B] bool).
    If crc_mat is given ([K, crc_len] over the full K bits incl. attached
    CRC), per-block early-exit freezes converged blocks (masked update —
    shape-static, so the compiled program is SNR-independent).

    window: windowed-BCJR window length (must divide K): cuts the scan
    length from K to `window` by running K/window windows in parallel
    with next-iteration-initialized boundaries (SURVEY.md §7 hard part
    1). auto_window enables it for large K.
    half: the windowed half-iteration, with the signature of
    ``_bcjr_half_windowed`` (the default); ``turbo_pallas`` passes its
    kernel here.
    """
    B = d_llrs.shape[0]
    if window is None and auto_window:
        window = pick_window(k)
    if window is not None:
        assert k % window == 0, f"window {window} must divide K={k}"
    perm = jnp.asarray(qpp_perm(k))
    inv = jnp.asarray(qpp_inv(k))

    sys1 = d_llrs[:, 0, :k]
    par1 = d_llrs[:, 1, :k]
    par2 = d_llrs[:, 2, :k]
    sys2 = sys1[:, perm]

    # tail demux (inverse of encode()):
    t = d_llrs[:, :, k : k + 4]  # [B, 3, 4]
    tail1_sys = jnp.stack([t[:, 0, 0], t[:, 2, 0], t[:, 1, 1]], axis=1)
    tail1_par = jnp.stack([t[:, 1, 0], t[:, 0, 1], t[:, 2, 1]], axis=1)
    tail2_sys = jnp.stack([t[:, 0, 2], t[:, 2, 2], t[:, 1, 3]], axis=1)
    tail2_par = jnp.stack([t[:, 1, 2], t[:, 0, 3], t[:, 2, 3]], axis=1)

    crc_m = None if crc_mat is None else jnp.asarray(crc_mat.astype(np.float32))

    def crc_ok_of(hard):
        if crc_m is None:
            return jnp.zeros((B,), bool)
        syn = jnp.mod(jnp.round(hard.astype(jnp.float32) @ crc_m), 2.0)
        return jnp.sum(syn, axis=-1) == 0

    if window is None:
        def body(carry, _):
            le21, done, iters_used, hard_prev = carry
            le12 = _bcjr_half(sys1, par1, le21, tail1_sys, tail1_par)
            le21_new = _bcjr_half(sys2, par2, le12[:, perm], tail2_sys, tail2_par)[:, inv]
            post = sys1 + le12 + le21_new
            hard = (post < 0).astype(jnp.uint8)
            ok = crc_ok_of(hard)
            # freeze blocks that already passed CRC
            mask = done[:, None]
            le21_out = jnp.where(mask, le21, le21_new)
            hard_out = jnp.where(mask, hard_prev, hard)
            iters_used = iters_used + (~done).astype(jnp.int32)
            done = done | ok
            return (le21_out, done, iters_used, hard_out), None

        init = (
            jnp.zeros((B, k), jnp.float32),
            jnp.zeros((B,), bool),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B, k), jnp.uint8),
        )
        (le21, done, iters_used, hard), _ = jax.lax.scan(
            body, init, None, length=n_iters
        )
        ok = crc_ok_of(hard) | done
        return hard, iters_used, ok

    W = k // window
    half = half or _bcjr_half_windowed

    def body_w(carry, _):
        le21, done, iters_used, hard_prev, ab1, bb1, ab2, bb2 = carry
        le12, ab1n, bb1n = half(
            sys1, par1, le21, tail1_sys, tail1_par, ab1, bb1, window
        )
        le21_raw, ab2n, bb2n = half(
            sys2, par2, le12[:, perm], tail2_sys, tail2_par, ab2, bb2, window
        )
        le21_new = le21_raw[:, inv]
        post = sys1 + le12 + le21_new
        hard = (post < 0).astype(jnp.uint8)
        ok = crc_ok_of(hard)
        mask = done[:, None]
        mask3 = done[:, None, None]
        le21_out = jnp.where(mask, le21, le21_new)
        hard_out = jnp.where(mask, hard_prev, hard)
        ab1 = jnp.where(mask3, ab1, ab1n)
        bb1 = jnp.where(mask3, bb1, bb1n)
        ab2 = jnp.where(mask3, ab2, ab2n)
        bb2 = jnp.where(mask3, bb2, bb2n)
        iters_used = iters_used + (~done).astype(jnp.int32)
        done = done | ok
        return (le21_out, done, iters_used, hard_out, ab1, bb1, ab2, bb2), None

    zb = jnp.zeros((B, W, 8), jnp.float32)
    init = (
        jnp.zeros((B, k), jnp.float32),
        jnp.zeros((B,), bool),
        jnp.zeros((B,), jnp.int32),
        jnp.zeros((B, k), jnp.uint8),
        zb, zb, zb, zb,
    )
    if crc_mat is not None and early_exit:
        # device-side early exit: stop as soon as EVERY block in the batch
        # passed CRC (the reference's max_noi early-stop semantics,
        # phch_worker.cc:87-89, at batch granularity). Shapes stay static;
        # only the trip count is data-dependent. early_exit=False forces
        # the full n_iters of compute (the honest-benchmark operating
        # point: BASELINE.md "8-iteration turbo decoding").
        def cond(state):
            i, carry = state
            done = carry[1]
            return (i < n_iters) & ~jnp.all(done)

        def step(state):
            i, carry = state
            carry, _ = body_w(carry, None)
            return (i + 1, carry)

        _, (le21, done, iters_used, hard, *_) = jax.lax.while_loop(
            cond, step, (jnp.int32(0), init)
        )
    else:
        (le21, done, iters_used, hard, *_), _ = jax.lax.scan(
            body_w, init, None, length=n_iters
        )
    ok = crc_ok_of(hard) | done
    return hard, iters_used, ok
