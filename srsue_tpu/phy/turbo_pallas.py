"""Windowed max-log-MAP half-iteration as a Pallas kernel for NVIDIA GPUs,
compiled through Triton (``backend="triton"``).

``turbo._bcjr_half_windowed`` runs each half-iteration as a forward and a
backward ``lax.scan`` over the window, so on a GPU every trellis step is
a few small kernel launches and the stacked alphas round-trip through
device memory. This kernel runs a whole half-iteration in one launch:

* One program decodes a tile of ``BLOCK`` (codeblock, window) pairs, one
  window per thread. The streams are laid out window-minor (``[lw, n]``,
  n = number of windows), so each trellis step loads one coalesced row.
* The 8 state metrics of each window live in registers.
* The recursion is radix-4 (two trellis steps per recursion step): the
  forward pass stores alphas at even steps only, and the backward pass
  is fused with the extrinsic output of both steps.
* It emits ``alpha_last``/``beta_first`` so the caller can initialise
  neighbouring windows in the next iteration.

The Triton route has no scratch memory, so the even-step alphas go to an
extra output, laid out step-major like the streams: every store and load
is one coalesced row, written and read back by the same thread within
one program.

Max-log BCJR only uses metric differences. Instead of subtracting the
per-step maximum as the reference does, the kernel subtracts state 0's
metric once per ``_GROUP`` radix-4 steps (8 trellis steps) and forms
two-step branch sums. The two take their f32 sums in another order, so
they differ by rounding of the path metrics, which grow with the window
length and the LLR magnitudes: ``half_tolerance`` states the bound.

QPP interleaving, the iteration loop, CRC early exit and HARQ stay in JAX
(``turbo.decode``); this module supplies only the half-iteration.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import turbo

BLOCK = 128  # windows per program: one per thread at 4 warps
_NUM_WARPS = 4
_GROUP = 4  # radix-4 steps between normalisations


def half_tolerance(lw: int, *llrs) -> float:
    """Largest allowed |kernel - reference| extrinsic difference:
    1e-6 * lw * max|L| over the input LLRs L (systematic + a priori, and
    parity), about 8 f32 ulps of the largest path metric lw * max|L|."""
    return 1e-6 * lw * max(float(jnp.max(jnp.abs(x))) for x in llrs)


@functools.lru_cache(maxsize=1)
def _radix4_tables():
    """Two-step (radix-4) trellis tables derived from the radix-2 ones.

    A branch metric is gamma(s, u) = u_sign*L/2 + p_sign*P/2, so with
    A = ((L+P)/2, (L-P)/2) at step t and B the same at step t+1, every
    two-step metric is sign * (A[x] +- B[y]). key = (x, y, d) names the
    8 such bases (d=0: A[x]+B[y], d=1: A[x]-B[y]).

    Returns (fwd, paths):
      fwd[s2] = 4 x (sp, key, sign): the two-step predecessors of s2;
      paths   = 32 x (sp, s2, key, sign, u1, u2): every two-step branch.
    """
    ns, par, _ = turbo._trellis()
    u_sign = (1, -1)
    p_sign = 1 - 2 * par
    paths = []
    fwd = [[] for _ in range(8)]
    for sp in range(8):
        for u1 in (0, 1):
            sm = int(ns[sp, u1])
            s1 = u_sign[u1]
            x = 0 if s1 * p_sign[sp, u1] > 0 else 1
            for u2 in (0, 1):
                s2sgn = u_sign[u2]
                y = 0 if s2sgn * p_sign[sm, u2] > 0 else 1
                s2 = int(ns[sm, u2])
                key = (x, y, 0 if s1 == s2sgn else 1)
                paths.append((sp, s2, key, s1, u1, u2))
                fwd[s2].append((sp, key, s1))
    assert all(len(f) == 4 for f in fwd)
    return fwd, tuple(paths)


def _max4(c):
    return jnp.maximum(jnp.maximum(c[0], c[1]), jnp.maximum(c[2], c[3]))


def _half_kernel(lin_ref, par_ref, a0_ref, b0_ref,
                 ext_ref, alast_ref, bfirst_ref, alpha_ref):
    """One half-iteration over BLOCK windows.

    lin/par: [lw, BLOCK] systematic+a-priori and parity LLRs
    a0/b0:   [8, BLOCK] initial alpha / beta of each window
    ext:     [lw, BLOCK] extrinsic LLRs
    alast/bfirst: [8, BLOCK] final alpha / beta of each window
    alpha:   [lw/2 * 8, BLOCK] even-step alphas (row = step/2 * 8 + state)
    """
    fwd_tab, paths = _radix4_tables()
    half = lin_ref.shape[0] // 2

    def branch(td):
        t = 2 * td
        l0, l1 = lin_ref[t], lin_ref[t + 1]
        p0, p1 = par_ref[t], par_ref[t + 1]
        a = (0.5 * (l0 + p0), 0.5 * (l0 - p0))
        b = (0.5 * (l1 + p1), 0.5 * (l1 - p1))
        g = {}
        for x in range(2):
            for y in range(2):
                g[(x, y, 0)] = a[x] + b[y]
                g[(x, y, 1)] = a[x] - b[y]
        return g, l0, l1

    def fwd_group(j, alpha):
        alpha = list(alpha)
        for i in range(_GROUP):
            td = j * _GROUP + i
            g, _, _ = branch(td)
            for s in range(8):
                alpha_ref[td * 8 + s] = alpha[s]
            alpha = [
                _max4([alpha[sp] + g[key] if sgn > 0 else alpha[sp] - g[key]
                       for sp, key, sgn in fwd_tab[s2]])
                for s2 in range(8)
            ]
        return tuple(a - alpha[0] for a in alpha)

    alpha = jax.lax.fori_loop(0, half // _GROUP, fwd_group,
                              tuple(a0_ref[s] for s in range(8)))
    for s in range(8):
        alast_ref[s] = alpha[s]

    def bwd_group(j, beta):
        beta = list(beta)
        for i in range(_GROUP):
            td = half - 1 - (j * _GROUP + i)
            g, l0, l1 = branch(td)
            cand = {}
            for sp, s2, key, sgn, u1, u2 in paths:
                cand[(sp, u1, u2)] = (beta[s2] + g[key] if sgn > 0
                                      else beta[s2] - g[key])
            beta = []
            best = {}
            for sp in range(8):
                c = [cand[(sp, u1, u2)] for u1 in (0, 1) for u2 in (0, 1)]
                beta.append(_max4(c))
                a_s = alpha_ref[td * 8 + sp]
                for u1 in (0, 1):
                    for u2 in (0, 1):
                        m = cand[(sp, u1, u2)] + a_s
                        best[(u1, u2)] = (m if sp == 0
                                          else jnp.maximum(best[(u1, u2)], m))
            ext_ref[2 * td] = (jnp.maximum(best[(0, 0)], best[(0, 1)])
                               - jnp.maximum(best[(1, 0)], best[(1, 1)])
                               - l0)
            ext_ref[2 * td + 1] = (jnp.maximum(best[(0, 0)], best[(1, 0)])
                                   - jnp.maximum(best[(0, 1)], best[(1, 1)])
                                   - l1)
        return tuple(b - beta[0] for b in beta)

    beta = jax.lax.fori_loop(0, half // _GROUP, bwd_group,
                             tuple(b0_ref[s] for s in range(8)))
    for s in range(8):
        bfirst_ref[s] = beta[s]


def half_windows(lin, par, a0, b0, interpret: bool = False):
    """The kernel on window-minor operands.

    lin/par: [lw, n]; a0/b0: [8, n]; n a multiple of BLOCK and lw a
    multiple of 2*_GROUP. Returns (ext [lw, n], alpha_last [8, n],
    beta_first [8, n]).
    """
    lw, n = lin.shape
    if n % BLOCK or lw % (2 * _GROUP):
        raise ValueError(f"need n % {BLOCK} == 0 and lw % {2 * _GROUP} == 0,"
                         f" got n={n}, lw={lw}")
    stream = pl.BlockSpec((lw, BLOCK), lambda i: (0, i))
    bound = pl.BlockSpec((8, BLOCK), lambda i: (0, i))
    store = pl.BlockSpec((lw // 2 * 8, BLOCK), lambda i: (0, i))
    f32 = jnp.float32
    ext, alast, bfirst, _ = pl.pallas_call(
        _half_kernel,
        grid=(n // BLOCK,),
        in_specs=[stream, stream, bound, bound],
        out_specs=[stream, bound, bound, store],
        out_shape=[
            jax.ShapeDtypeStruct((lw, n), f32),
            jax.ShapeDtypeStruct((8, n), f32),
            jax.ShapeDtypeStruct((8, n), f32),
            jax.ShapeDtypeStruct((lw // 2 * 8, n), f32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="turbo_bcjr_half",
    )(lin, par, a0, b0)
    return ext, alast, bfirst


def bcjr_half_windowed(sys_llr, par_llr, apriori, tail_sys, tail_par,
                       alpha_b, beta_b, lw: int, interpret: bool = False):
    """Drop-in for ``turbo._bcjr_half_windowed`` backed by the kernel.

    [B, K] LLRs, [B, 3] tails, [B, K/lw, 8] carried boundaries. Returns
    (extrinsic [B, K], new_alpha_b, new_beta_b)."""
    B, K = sys_llr.shape
    W = K // lw
    n = B * W
    pad = (-n) % BLOCK

    def to_wm(x, d):  # [B, ..] -> [d, n + pad], window-minor
        return jnp.pad(x.reshape(n, d).T, ((0, 0), (0, pad)))

    def from_wm(y, shape):
        return y[:, :n].T.reshape(shape)

    a0, b0 = turbo._window_inits(alpha_b, beta_b, tail_sys, tail_par)
    ext, alast, bfirst = half_windows(
        to_wm(sys_llr + apriori, lw), to_wm(par_llr, lw),
        to_wm(a0, 8), to_wm(b0, 8), interpret=interpret)
    new_alpha_b, new_beta_b = turbo._chain_boundaries(
        from_wm(alast, (B, W, 8)), from_wm(bfirst, (B, W, 8)))
    return from_wm(ext, (B, K)), new_alpha_b, new_beta_b


def decode(d_llrs, k: int, n_iters: int = 8, crc_mat=None,
           window: int | None = None, early_exit: bool = True,
           interpret: bool = False):
    """``turbo.decode`` with the kernel as its windowed half-iteration.
    window defaults to ``turbo.pick_window(k)``; K with no window is an
    error here (the caller keeps such blocks on ``turbo.decode``)."""
    window = window or turbo.pick_window(k)
    if window is None:
        raise ValueError(f"no BCJR window divides K={k}")
    return turbo.decode(
        d_llrs, k, n_iters=n_iters, crc_mat=crc_mat, window=window,
        early_exit=early_exit,
        half=functools.partial(bcjr_half_windowed, interpret=interpret))
