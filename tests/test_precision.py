"""Matmul precision on the DL path.

A GPU runs a float32 matmul in TF32 (10-bit mantissa) unless a precision
is stated. The DL matmuls of channel estimation, sync and control state
``Precision.HIGHEST``; the CRC syndrome matmuls need no statement because
they stay exact with reduced-precision operands: the operands are 0/1,
which every format holds exactly, and the f32 sums are integers below
2^24.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srsue_tpu.phy import chest, control, convcode, crc, sync
from srsue_tpu.phy.cell import Cell


def _round_to_tf32(x: np.ndarray) -> np.ndarray:
    """Round-toward-zero to TF32's 10 explicit mantissa bits."""
    u = np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)
    return u.view(np.float32)


@pytest.mark.parametrize("n,kind", [(40, "24A"), (1000, "24B"),
                                    (6120, "24A"), (57, "16")])
def test_crc_syndrome_exact_with_reduced_precision_operands(n, kind):
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, (16, n)).astype(np.float32)
    m = crc.crc_matrix(n, kind).astype(np.float32)
    want = (bits.astype(np.int64) @ m.astype(np.int64)) % 2
    tf32 = jnp.matmul(jnp.asarray(_round_to_tf32(bits)),
                      jnp.asarray(_round_to_tf32(m)))
    bf16 = jnp.matmul(jnp.asarray(bits, jnp.bfloat16),
                      jnp.asarray(m, jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    for got in (tf32, bf16):
        np.testing.assert_array_equal(
            np.mod(np.round(np.asarray(got)), 2.0).astype(np.int64), want)


def _dot_precisions(fn, *args):
    """Precision config of every dot_general in fn's jaxpr (recursing
    into sub-jaxprs such as scan bodies)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                subs = v if isinstance(v, (list, tuple)) else [v]
                for sub in subs:
                    if hasattr(sub, "jaxpr"):
                        walk(getattr(sub.jaxpr, "jaxpr", sub.jaxpr))
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


_CELL = Cell(n_prb=6, cell_id=3)
_GRID = jnp.ones((2, _CELL.n_sym_sf, _CELL.n_sc), jnp.complex64)


@pytest.mark.parametrize("name,fn,args", [
    ("chest.estimate", lambda g: chest.estimate(_CELL, g, 0)[0], (_GRID,)),
    ("control.pcfich_decode",
     lambda g: control.pcfich_decode(_CELL, g, 0.1, 1)[1], (_GRID,)),
    ("control.phich_decode",
     lambda g: control.phich_decode(_CELL, g, 1, 0, 0), (_GRID,)),
    ("sync.sss_identify",
     lambda x: sync.sss_identify(x, 1)[2],
     (jnp.ones((2, 62), jnp.complex64),)),
    ("sync.decimate", lambda x: sync.decimate(x, 4),
     (jnp.ones((2, 256), jnp.complex64),)),
    ("convcode.decode", convcode.decode, (jnp.ones((2, 40, 3)),)),
])
def test_dl_matmuls_state_highest_precision(name, fn, args):
    precs = _dot_precisions(fn, *args)
    assert precs, f"{name}: no matmul found"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precs), (name, precs)


@pytest.mark.gpu
def test_crc_syndrome_exact_on_gpu_default_precision(gpu_device):
    """On the card the syndrome matmul runs at the default (TF32)
    precision and still equals the integer syndrome."""
    rng = np.random.default_rng(0)
    n = 6120
    bits = rng.integers(0, 2, (256, n)).astype(np.float32)
    m = crc.crc_matrix(n, "24A").astype(np.float32)
    want = (bits.astype(np.int64) @ m.astype(np.int64)) % 2
    got = jax.jit(lambda b, mm: jnp.mod(jnp.round(b @ mm), 2.0))(
        jax.device_put(bits, gpu_device), jax.device_put(m, gpu_device))
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64), want)
