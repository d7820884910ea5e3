"""Mesh construction and sharded multi-carrier decode.

The reference's one real parallelism strategy is pipelining subframes
over 2-4 worker threads with an ordered-commit mutex ring
(ue/src/phy/phch_common.cc:210-240). On a mesh of devices the equivalent
axes are:

* ``carrier`` (data parallel): independent carriers/UEs/subframes shard
  across devices — no cross-device traffic on the hot path, exactly like
  the reference's independent TTIs; ordering is array order (the
  deterministic replacement of the TX mutex ring).
* cross-carrier reductions (cell-level metrics, BLER accounting) become
  collectives (psum) over the mesh — the only communication, over
  NVLink between GPUs.

The mesh is a flat list of devices: GPUs of one host reach each other
all to all at the same rate, so the layout follows the algorithm alone.

``shard_decode`` builds the jitted sharded program; tests run it on the
8-device virtual CPU mesh and ``chip_smoke.py --four`` on four GPUs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..phy import chest, equalize, ofdm
from ..phy.cell import Cell
from ..phy.pdsch import PdschCodec


def make_mesh(n_devices: int | None = None, axis: str = "carrier") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_decode(
    cell: Cell,
    codec: PdschCodec,
    mesh: Mesh,
    axis: str = "carrier",
):
    """Returns (jitted_fn, input_sharding, replicated_sharding): batched
    PDSCH decode with the batch (carrier) axis sharded over the mesh.
    Each device runs the whole chain on its own carriers (``shard_map``:
    the FFT and the turbo kernel see only local data); the function also
    returns mesh-global aggregates (TB pass count, mean SNR) reduced by
    collectives."""
    subframe = codec.subframe
    in_spec = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    def local(iq):
        grid = ofdm.demodulate(cell, iq)
        h, nvar, rsrp = chest.estimate(cell, grid, subframe, port=0)
        x_eq, nv_eff = equalize.zf(
            codec.extract_re(grid), codec.extract_re(h), nvar
        )
        payload, tb_ok, blk_ok, iters = codec.decode(x_eq, nv_eff)
        # mesh-global aggregates -> all-reduce across shards (equal
        # shard sizes, so the mean of local means is the global mean).
        # snr_db: mean linear power ratio converted to dB.
        n_ok = jax.lax.psum(jnp.sum(tb_ok.astype(jnp.int32)), axis)
        snr_lin = jax.lax.pmean(jnp.mean(rsrp / jnp.maximum(nvar, 1e-12)),
                                axis)
        snr = 10.0 * jnp.log10(jnp.maximum(snr_lin, 1e-12))
        return payload.astype(jnp.int32), tb_ok, n_ok, snr

    run = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=P(axis),
        out_specs=(P(axis), P(axis), P(), P()),
        # the decoder's loop carries start from constants that do not
        # vary over the mesh; every value here is per-carrier except the
        # two reductions above, so the varying-axes check adds nothing
        check_vma=False,
    ))
    return run, in_spec, repl
