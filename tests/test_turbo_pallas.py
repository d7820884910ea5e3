"""The GPU turbo kernel (Pallas, Triton route) run in interpret mode on
the CPU against the pure-JAX windowed decoder, plus the wrapper's
layout and the backend selector in ``pdsch._turbo_decode``.

The half-iteration comparison uses the tolerance the kernel module
states (``turbo_pallas.half_tolerance``): the kernel normalises by state
0 once per 8 trellis steps and forms two-step branch sums, so its f32
sums round differently from the reference's. Boundary metrics are
defined up to a per-window offset and are compared after subtracting
their maximum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srsue_tpu.phy import crc as crcmod
from srsue_tpu.phy import pdsch, turbo, turbo_pallas


def _make(k, b, snr_db, rng):
    m = np.zeros((k, 24), np.uint8)
    m[: k - 24] = crcmod.crc_matrix(k - 24, "24A")
    m[k - 24 :] = np.eye(24, dtype=np.uint8)
    payloads, llrs = [], []
    for _ in range(b):
        p = rng.integers(0, 2, k - 24).astype(np.uint8)
        msg = crcmod.attach(p, "24A")
        x = 1.0 - 2.0 * turbo.encode(msg).astype(np.float32)
        sigma = 10 ** (-snr_db / 20)
        x = x + rng.standard_normal(x.shape).astype(np.float32) * sigma
        llrs.append(2 * x / sigma**2)
        payloads.append(msg)
    return np.stack(payloads), np.stack(llrs), m


def _tails(llrs, k):
    t = llrs[:, :, k : k + 4]
    tail_sys = np.stack([t[:, 0, 0], t[:, 2, 0], t[:, 1, 1]], 1)
    tail_par = np.stack([t[:, 1, 0], t[:, 0, 1], t[:, 2, 1]], 1)
    return jnp.asarray(tail_sys), jnp.asarray(tail_par)


def _offset_free(x):
    x = np.asarray(x)
    return x - x.max(axis=-1, keepdims=True)


@pytest.mark.parametrize(
    "k,lw,b,tails,chained",
    [
        (512, 64, 3, True, False),    # fresh boundaries, trellis tails
        (512, 64, 3, False, False),   # zero tail LLRs
        (1024, 32, 2, True, True),    # carried boundaries, short window
        (768, 96, 2, True, True),     # window that is not a power of 2
        (6144, 64, 2, True, True),    # largest LTE block, 96 windows
    ],
)
def test_half_kernel_matches_reference(k, lw, b, tails, chained):
    rng = np.random.default_rng(k + lw)
    _, llrs, _ = _make(k, b, 2.0, rng)
    sys1 = jnp.asarray(llrs[:, 0, :k])
    par1 = jnp.asarray(llrs[:, 1, :k])
    tail_sys, tail_par = _tails(llrs, k)
    if not tails:
        tail_sys = jnp.zeros_like(tail_sys)
        tail_par = jnp.zeros_like(tail_par)
    W = k // lw
    apriori = jnp.asarray(rng.standard_normal((b, k)).astype(np.float32) * 3)
    if chained:
        ab = jnp.asarray(rng.standard_normal((b, W, 8)).astype(np.float32))
        bb = jnp.asarray(rng.standard_normal((b, W, 8)).astype(np.float32))
    else:
        ab = bb = jnp.zeros((b, W, 8), jnp.float32)

    ref = turbo._bcjr_half_windowed(sys1, par1, apriori, tail_sys, tail_par,
                                    ab, bb, lw)
    got = turbo_pallas.bcjr_half_windowed(sys1, par1, apriori, tail_sys,
                                          tail_par, ab, bb, lw,
                                          interpret=True)
    tol = turbo_pallas.half_tolerance(lw, sys1 + apriori, par1)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=0, atol=tol)
    for g, r in zip(got[1:], ref[1:]):
        assert g.shape == r.shape == (b, W, 8)
        np.testing.assert_allclose(_offset_free(g), _offset_free(r),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("n,lw", [(128, 16), (256, 64), (384, 8)])
def test_half_windows_shapes(n, lw):
    rng = np.random.default_rng(n)
    lin = jnp.asarray(rng.standard_normal((lw, n)).astype(np.float32))
    par = jnp.asarray(rng.standard_normal((lw, n)).astype(np.float32))
    z = jnp.zeros((8, n), jnp.float32)
    ext, alast, bfirst = turbo_pallas.half_windows(lin, par, z, z,
                                                   interpret=True)
    assert ext.shape == (lw, n) and alast.shape == bfirst.shape == (8, n)
    assert np.isfinite(np.asarray(ext)).all()
    # state-0 normalisation: the last group leaves state 0 at zero
    np.testing.assert_array_equal(np.asarray(alast[0]), 0.0)
    np.testing.assert_array_equal(np.asarray(bfirst[0]), 0.0)


@pytest.mark.parametrize("n,lw", [(100, 64), (128, 12)])
def test_half_windows_rejects_bad_tiles(n, lw):
    x = jnp.zeros((lw, n), jnp.float32)
    z = jnp.zeros((8, n), jnp.float32)
    with pytest.raises(ValueError):
        turbo_pallas.half_windows(x, x, z, z, interpret=True)


def test_padding_windows_do_not_leak():
    """Windows beyond B*W (the pad to a multiple of BLOCK) are dropped,
    and the real windows do not depend on them."""
    k, lw, b = 512, 64, 3  # 24 windows, padded to 128
    rng = np.random.default_rng(5)
    _, llrs, _ = _make(k, b, 2.0, rng)
    sys1 = jnp.asarray(llrs[:, 0, :k])
    par1 = jnp.asarray(llrs[:, 1, :k])
    tail_sys, tail_par = _tails(llrs, k)
    zb = jnp.zeros((b, k // lw, 8), jnp.float32)
    z = jnp.zeros((b, k), jnp.float32)
    one = turbo_pallas.bcjr_half_windowed(sys1[:1], par1[:1], z[:1],
                                          tail_sys[:1], tail_par[:1],
                                          zb[:1], zb[:1], lw, interpret=True)
    all3 = turbo_pallas.bcjr_half_windowed(sys1, par1, z, tail_sys,
                                           tail_par, zb, zb, lw,
                                           interpret=True)
    for a, c in zip(one, all3):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c[:1]))


@pytest.mark.parametrize("k", [512, 5824])
@pytest.mark.parametrize("early_exit", [False, True])
def test_full_decode_matches_reference(k, early_exit):
    rng = np.random.default_rng(k)
    payloads, llrs, m = _make(k, 2, 1.0, rng)
    d = jnp.asarray(llrs)
    h_ref, it_ref, ok_ref = turbo.decode(d, k, 4, crc_mat=m,
                                         early_exit=early_exit)
    h, it, ok = turbo_pallas.decode(d, k, 4, crc_mat=m,
                                    early_exit=early_exit, interpret=True)
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(h), payloads)
    np.testing.assert_array_equal(np.asarray(h), np.asarray(h_ref))
    np.testing.assert_array_equal(np.asarray(it), np.asarray(it_ref))
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(ok_ref))


def test_decode_rejects_k_without_window():
    with pytest.raises(ValueError):
        turbo_pallas.decode(jnp.zeros((1, 3, 44)), 40, interpret=True)


@pytest.mark.parametrize("backend,k,want", [
    ("gpu", 5824, "kernel"),
    ("gpu", 256, "xla"),    # too short for windows
    ("cpu", 5824, "xla"),
])
def test_selector_picks_kernel_on_gpu_only(monkeypatch, backend, k, want):
    """pdsch._turbo_decode takes the compiled kernel on a GPU (never
    interpret mode) and turbo.decode elsewhere."""
    calls = []

    def fake_kernel(d, k, **kw):
        calls.append(("kernel", kw))
        return "kernel"

    def fake_xla(d, k, **kw):
        calls.append(("xla", kw))
        return "xla"

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(turbo_pallas, "decode", fake_kernel)
    monkeypatch.setattr(turbo, "decode", fake_xla)
    assert pdsch._turbo_decode(None, k, 8, None, early_exit=False) == want
    (name, kw), = calls
    assert name == want
    assert kw.get("interpret", False) is False
    assert kw["early_exit"] is False and kw["n_iters"] == 8


@pytest.mark.gpu
def test_compiled_kernel_matches_reference_on_gpu(gpu_device):
    """The kernel as compiled for the card (no interpret mode) against
    the reference half-iteration and full decode."""
    k, lw, b = 6144, 64, 64
    rng = np.random.default_rng(3)
    payloads, llrs, m = _make(k, b, 1.0, rng)
    d = jax.device_put(llrs, gpu_device)
    sys1, par1 = d[:, 0, :k], d[:, 1, :k]
    tail_sys, tail_par = _tails(llrs, k)
    zb = jnp.zeros((b, k // lw, 8), jnp.float32)
    z = jnp.zeros((b, k), jnp.float32)
    got = jax.jit(lambda *a: turbo_pallas.bcjr_half_windowed(*a, lw))(
        sys1, par1, z, tail_sys, tail_par, zb, zb)
    ref = turbo._bcjr_half_windowed(sys1, par1, z, tail_sys, tail_par,
                                    zb, zb, lw)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=0,
                               atol=turbo_pallas.half_tolerance(lw, sys1,
                                                                par1))
    h, it, ok = jax.jit(lambda x: turbo_pallas.decode(x, k, 8, crc_mat=m))(d)
    h_ref, it_ref, ok_ref = turbo.decode(d, k, 8, crc_mat=m)
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(h), payloads)
    np.testing.assert_array_equal(np.asarray(h), np.asarray(h_ref))
    np.testing.assert_array_equal(np.asarray(it), np.asarray(it_ref))
