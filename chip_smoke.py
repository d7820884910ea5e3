"""Smoke test of the LTE receive chain on NVIDIA GPUs: every phase runs
on the card, in this one process, and checks its results against the
repo's plain references.

    python3 chip_smoke.py          # one card, every phase below
    python3 chip_smoke.py --four   # four cards: the sharded paths only

One card:
  turbo    the Pallas BCJR kernel against ``turbo._bcjr_half_windowed``
           on the flagship batch's LLRs at 26 dB (3,328 codeblocks,
           K = 5824, window 64); full decodes through the kernel and
           through ``turbo.decode`` give identical hard bits and CRC at
           26 and 20 dB; kernel vs XLA decode times.
  demod    ``ofdm.demodulate`` (cuFFT) against ``ofdm.demodulate_np``.
  flagship the whole blind chain (20 MHz, 64QAM, TBS 75,376, 13
           codeblocks) on 256 subframes, 8 forced iterations and CRC
           early exit: every TB CRC passes, payloads bit-exact, blind DCI
           and CFI found in every subframe; compiled memory and peak use.
  tm2      the 2-port SFBC chain on 128 subframes, every TB passes.
  entry    ``srsue_tpu.main.main(["--iq", ...])`` on a seeded capture
           from the in-repo eNB transmitter (cell search, MIB, PDSCH),
           then ``--selftest``.

Four cards (``--four``): ``mesh.shard_decode`` at the flagship shape
against the same IQ on one card, ``turbo_shard`` at K = 6144 against
``turbo.decode``, and ``timeshard.sharded_frontend`` against
``ofdm.demodulate``.

A failed check raises and the process exits non-zero without a result.
The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

SNR_OPERATING = 26.0
SNR_WATERFALL = 20.0
# f32 FFT of 2048 points: rounding grows like log2(N) ulps of the
# largest bin (~1e-6 relative); 1e-5 leaves a factor of ten.
DEMOD_RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {what}")
    log(f"  ok: {what}")


def timed(f, *args, reps: int = 5):
    """Warm call, then `reps` calls each ended by block_until_ready.
    Returns (last output, per-call seconds)."""
    import jax

    out = jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return out, ts


def ms(ts) -> str:
    return (f"median {np.median(ts) * 1e3:.3f} ms "
            f"(min {min(ts) * 1e3:.3f}, max {max(ts) * 1e3:.3f}, n={len(ts)})")


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------


def softbuffer_fn(cell, codec, subframe):
    """IQ pairs -> the decoder's input d_llrs [B*C, 3, K+4] (flagship
    grant: one codeblock size)."""
    from srsue_tpu.phy import chest, equalize, ofdm
    from srsue_tpu.utils.jaxutil import iq_complex

    def fn(iq_p):
        grid = ofdm.demodulate(cell, iq_complex(iq_p))
        h, nvar, _ = chest.estimate(cell, grid, subframe, port=0)
        x_eq, nv = equalize.zf(codec.extract_re(grid), codec.extract_re(h),
                               nvar)
        (buf,) = codec.dematch(codec.demap_llrs(x_eq, nv))
        k = codec.block_ks[0]
        return buf.reshape(-1, 3, k + 4)

    return fn


def phase_turbo(ctx):
    import jax
    import jax.numpy as jnp

    from srsue_tpu.phy import turbo, turbo_pallas

    log("== turbo: Pallas BCJR kernel vs turbo._bcjr_half_windowed / "
        "turbo.decode")
    codec, k = ctx["codec"], ctx["codec"].block_ks[0]
    lw = turbo.pick_window(k)
    crc_mat = codec._blk_crc[k]
    sb = jax.jit(softbuffer_fn(ctx["cell"], codec, ctx["subframe"]))
    d = {snr: sb(ctx["iq"][snr]) for snr in (SNR_OPERATING, SNR_WATERFALL)}
    d26 = d[SNR_OPERATING]
    n_blk = d26.shape[0]
    log(f"  {n_blk} codeblocks, K={k}, window {lw}")

    sys1, par1 = d26[:, 0, :k], d26[:, 1, :k]
    t = d26[:, :, k:k + 4]
    tail_sys = jnp.stack([t[:, 0, 0], t[:, 2, 0], t[:, 1, 1]], axis=1)
    tail_par = jnp.stack([t[:, 1, 0], t[:, 0, 1], t[:, 2, 1]], axis=1)
    zb = jnp.zeros((n_blk, k // lw, 8), jnp.float32)
    half_k = jax.jit(lambda *a: turbo_pallas.bcjr_half_windowed(*a, lw))
    half_x = jax.jit(lambda *a: turbo._bcjr_half_windowed(*a, lw))

    def offset_free(x):
        return x - jnp.max(x, axis=-1, keepdims=True)

    # first half-iteration from fresh boundaries, then one fed with the
    # reference's own extrinsics and boundaries (the chained case)
    apri = jnp.zeros_like(sys1)
    args = (sys1, par1, apri, tail_sys, tail_par, zb, zb)
    for label in ("fresh", "chained"):
        ref = half_x(*args)
        got = half_k(*args)
        tol = turbo_pallas.half_tolerance(lw, args[0] + args[2], par1)
        diff = float(jnp.max(jnp.abs(got[0] - ref[0])))
        bdiff = max(float(jnp.max(jnp.abs(offset_free(g) - offset_free(r))))
                    for g, r in zip(got[1:], ref[1:]))
        check(diff <= tol and bdiff <= tol,
              f"half-iteration ({label}) extrinsic max|diff| {diff:.3e}, "
              f"boundaries {bdiff:.3e} <= tolerance {tol:.3e}")
        args = (sys1, par1, ref[0], tail_sys, tail_par, ref[1], ref[2])

    decode_k = {ee: jax.jit(lambda d, ee=ee: turbo_pallas.decode(
        d, k, 8, crc_mat=crc_mat, early_exit=ee)) for ee in (False, True)}
    decode_x = {ee: jax.jit(lambda d, ee=ee: turbo.decode(
        d, k, 8, crc_mat=crc_mat, early_exit=ee)) for ee in (False, True)}
    for snr in (SNR_OPERATING, SNR_WATERFALL):
        for ee in (False, True):
            hk, ik, okk = decode_k[ee](d[snr])
            hx, ix, okx = decode_x[ee](d[snr])
            mode = "early exit" if ee else "8 forced iterations"
            check(bool(jnp.all(hk == hx)) and bool(jnp.all(okk == okx))
                  and bool(jnp.all(ik == ix)),
                  f"{snr:.0f} dB, {mode}: kernel and turbo.decode agree on "
                  f"hard bits, CRC ({int(okk.sum())}/{n_blk} pass) and "
                  f"iterations (mean {float(ik.mean()):.2f})")

    _, tk = timed(decode_k[False], d26)
    _, tx = timed(decode_x[False], d26)
    log(f"  time, 8 forced iterations, {n_blk} x K={k}: "
        f"kernel {ms(tk)}; XLA turbo.decode {ms(tx)}")


def phase_demod(ctx):
    import jax

    from srsue_tpu.phy import ofdm

    log("== demod: ofdm.demodulate (cuFFT) vs ofdm.demodulate_np")
    cell = ctx["cell"]
    iq = ctx["td_noisy"][SNR_OPERATING][:32]
    n = len(iq)
    got = np.asarray(jax.jit(lambda v: ofdm.demodulate(cell, v))(iq))
    ref = ofdm.demodulate_np(cell, iq)
    err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    check(got.shape == ref.shape == (n, cell.n_sym_sf, cell.n_sc)
          and err <= DEMOD_RTOL,
          f"{n} subframes x 14 x 2048-point FFT: max|diff|/max|ref| "
          f"{err:.2e} <= {DEMOD_RTOL:.0e}")


def phase_flagship(ctx, dev):
    import jax

    import bench

    log("== flagship: 20 MHz 64QAM max TBS, blind PDCCH, B = "
        f"{ctx['B']} subframes")
    B = ctx["B"]
    args = (ctx["cell"], ctx["grant"], ctx["subframe"], ctx["cfi"],
            ctx["rnti"], ctx["dci_bits"], ctx["payloads"].astype(np.float32))
    iq = ctx["iq"][SNR_OPERATING]
    for ee in (False, True):
        mode = "early exit" if ee else "8 forced iterations"
        rx = jax.jit(bench.make_rx(*args, early_exit=ee))
        t0 = time.perf_counter()
        compiled = rx.lower(iq).compile()
        t_compile = time.perf_counter() - t0
        s, ts = timed(compiled, iq, reps=3)
        s = np.asarray(s)
        check(s[0, 0] == B, f"{mode}: TB CRC pass {s[0, 0]:.0f}/{B}")
        check(s[0, 1] == 1.0, f"{mode}: payloads bit-exact")
        check(s[0, 3] == B, f"{mode}: blind DCI found {s[0, 3]:.0f}/{B}")
        check(s[0, 4] == B, f"{mode}: CFI {s[0, 4]:.0f}/{B}")
        mbps = B * ctx["grant"].tbs / np.median(ts) / 1e6
        log(f"  {mode}: mean iterations {s[0, 2]:.2f}; compile "
            f"{t_compile:.1f} s; step {ms(ts)} -> {mbps:.1f} Mbps")
        if not ee:
            mem = compiled.memory_analysis()
            log(f"  memory_analysis: arguments {mem.argument_size_in_bytes}"
                f" B, outputs {mem.output_size_in_bytes} B, temporaries "
                f"{mem.temp_size_in_bytes} B, generated code "
                f"{mem.generated_code_size_in_bytes} B")
            peak = dev.memory_stats()["peak_bytes_in_use"]
            log(f"  memory_stats peak_bytes_in_use: {peak} B")


def phase_tm2(B2: int = 128):
    import jax
    import jax.numpy as jnp

    import bench
    from srsue_tpu.utils.jaxutil import iq_pairs

    log(f"== tm2: 2-port SFBC chain, B = {B2} subframes")
    cell, grant, sf, rnti, codec, pl, td, p_sig, rng = bench.build_tm2(B2)
    iq = jnp.asarray(iq_pairs(bench.add_noise(rng, td, p_sig,
                                              SNR_OPERATING + 2)))
    rx = jax.jit(bench.make_tm2_rx(cell, codec, sf, pl.astype(np.float32)))
    s, ts = timed(rx, iq, reps=3)
    s = np.asarray(s)
    check(s[0, 0] == B2 and s[0, 1] == 1.0,
          f"TM2 TB CRC pass {s[0, 0]:.0f}/{B2}, payloads bit-exact")
    log(f"  step {ms(ts)}")


def phase_entry(n_prb: int = 100, n_frames: int = 5):
    from srsue_tpu import main as ue_main
    from srsue_tpu.enb.capture import build_downlink
    from srsue_tpu.phy.cell import Cell
    from srsue_tpu.radio.radio import write_iq

    data_sfs = (2, 3, 7, 8)
    log(f"== entry: srsue_tpu.main --iq on a {n_prb}-PRB capture of "
        f"{n_frames * 10} subframes (C-RNTI data in {len(data_sfs)} per "
        "frame)")
    cell = Cell(n_prb=n_prb, cell_id=77)
    td, _, _ = build_downlink(cell, n_frames=n_frames, snr_db=20, seed=3,
                              crnti=0x4601, mcs_data=10, data_sfs=data_sfs)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "capture.iq")
        write_iq(path, td)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = ue_main.main(["--iq", path, "--srate", str(cell.srate),
                               "--rnti", "0x4601"])
    out = err.getvalue()
    for line in out.splitlines():
        if not line.startswith("  ") and "|" not in line:
            log(f"  | {line}")
    m = re.search(r"decoded (\d+) TBs", out)
    n_tb = int(m.group(1)) if m else 0
    check(rc == 0 and f"cell_id={cell.cell_id}" in out
          and f"n_prb={n_prb}" in out,
          f"--iq: cell search and MIB found cell 77, {n_prb} PRB (rc {rc})")
    want = len(data_sfs) * (n_frames - 1)
    check(n_tb >= want, f"--iq: decoded {n_tb} TBs (>= {want})")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ue_main.main(["--selftest"])
    log(f"  | {out.getvalue().strip()}")
    check(rc == 0 and "SELFTEST PASS" in out.getvalue(), "--selftest")


def build_flagship(B: int) -> dict:
    import jax.numpy as jnp

    import bench
    from srsue_tpu.phy.pdsch import PdschCodec
    from srsue_tpu.utils.jaxutil import iq_pairs

    t0 = time.perf_counter()
    (cell, grant, subframe, cfi, rnti, dci_bits, payloads, td, p_sig,
     rng) = bench.build_clean(B)
    noisy = {snr: bench.add_noise(rng, td, p_sig, snr)
             for snr in (SNR_OPERATING, SNR_WATERFALL)}
    ctx = dict(
        B=B, cell=cell, grant=grant, subframe=subframe, cfi=cfi, rnti=rnti,
        dci_bits=dci_bits, payloads=payloads, td_noisy=noisy,
        iq={snr: jnp.asarray(iq_pairs(v)) for snr, v in noisy.items()},
        codec=PdschCodec(cell, grant, rnti=rnti, subframe=subframe, cfi=cfi,
                         n_turbo_iters=8, early_exit=False),
    )
    log(f"  built {B} subframes (TBS {grant.tbs}, "
        f"{ctx['codec'].plan.c} codeblocks) in "
        f"{time.perf_counter() - t0:.1f} s")
    return ctx


def run_one_card(dev, B: int) -> None:
    ctx = build_flagship(B)
    phase_turbo(ctx)
    phase_demod(ctx)
    phase_flagship(ctx, dev)
    phase_tm2()
    phase_entry()


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def device_ids(x) -> list[int]:
    return sorted(d.id for d in x.sharding.device_set)


def run_four_cards(n_dev: int, B: int) -> None:
    import jax
    import jax.numpy as jnp

    from srsue_tpu.parallel import timeshard, turbo_shard
    from srsue_tpu.parallel.mesh import make_mesh, shard_decode
    from srsue_tpu.phy import crc as crcmod
    from srsue_tpu.phy import ofdm, turbo
    from srsue_tpu.phy.pdsch import PdschCodec

    ctx = build_flagship(B)
    cell = ctx["cell"]
    iq_np = ctx["td_noisy"][SNR_OPERATING].astype(np.complex64)

    log(f"== mesh.shard_decode: {B} subframes over {n_dev} cards vs one card")
    codec = PdschCodec(cell, ctx["grant"], rnti=ctx["rnti"],
                       subframe=ctx["subframe"], cfi=ctx["cfi"],
                       n_turbo_iters=8, early_exit=False)
    outs = {}
    for n in (n_dev, 1):
        run, in_spec, _ = shard_decode(cell, codec, make_mesh(n))
        iq = jax.device_put(iq_np, in_spec)
        out, ts = timed(run, iq, reps=3)
        outs[n] = out
        log(f"  {n} card(s): payload on devices {device_ids(out[0])}, "
            f"tb_ok on {device_ids(out[1])}; step {ms(ts)}")
    (p4, ok4, n4, _), (p1, ok1, n1, _) = outs[n_dev], outs[1]
    check(int(n4) == B and bool(jnp.all(ok4)),
          f"{n_dev} cards: TB CRC pass {int(n4)}/{B}")
    check(np.array_equal(np.asarray(p4), np.asarray(p1))
          and np.array_equal(np.asarray(ok4), np.asarray(ok1)),
          f"{n_dev}-card payloads and CRC bit-identical to one card")
    check(np.array_equal(np.asarray(p4).astype(np.uint8), ctx["payloads"]),
          "payloads equal the transmitted bits")

    k = 6144
    log(f"== turbo_shard: K={k} windows over {n_dev} cards vs turbo.decode")
    m = np.zeros((k, 24), np.uint8)
    m[: k - 24] = crcmod.crc_matrix(k - 24, "24A")
    m[k - 24:] = np.eye(24, dtype=np.uint8)
    rng = np.random.default_rng(7)
    msgs = np.stack([crcmod.attach(rng.integers(0, 2, k - 24).astype(
        np.uint8), "24A") for _ in range(64)])
    x = 1.0 - 2.0 * np.stack([turbo.encode(b) for b in msgs]).astype(
        np.float32)
    sigma = 10 ** (-1.0 / 20)
    llr = jnp.asarray(2 * (x + sigma * rng.standard_normal(x.shape).astype(
        np.float32)) / sigma ** 2)
    srun = turbo_shard.make_sharded_decoder(
        k, 8, make_mesh(n_dev, axis="win"), window=64, crc_mat=m)
    (hs, its, oks), ts = timed(srun, llr, reps=3)
    log(f"  hard bits on devices {device_ids(hs)}; step {ms(ts)}")
    hl, itl, okl = jax.jit(lambda d: turbo.decode(d, k, 8, crc_mat=m,
                                                  window=64))(llr)
    check(bool(jnp.all(oks)) and np.array_equal(np.asarray(hs), msgs),
          f"sharded decode: CRC {int(oks.sum())}/64 pass, bits exact")
    check(np.array_equal(np.asarray(hs), np.asarray(hl))
          and np.array_equal(np.asarray(oks), np.asarray(okl)),
          "sharded hard bits and CRC identical to turbo.decode")

    n_sf = min(8, B // n_dev)
    log(f"== timeshard.sharded_frontend: {n_dev * n_sf} subframes in time "
        f"blocks over {n_dev} cards vs ofdm.demodulate")
    stream = iq_np[: n_dev * n_sf].reshape(-1)
    trun, t_in, _ = timeshard.sharded_frontend(cell, make_mesh(
        n_dev, axis="time"), n_sf)
    grids, ts = timed(trun, jax.device_put(stream, t_in), reps=3)
    log(f"  grids on devices {device_ids(grids)}; step {ms(ts)}")
    ref = np.asarray(jax.jit(lambda v: ofdm.demodulate(cell, v))(
        stream.reshape(n_dev * n_sf, cell.sf_len)))
    err = float(np.max(np.abs(np.asarray(grids) - ref)) / np.max(np.abs(ref)))
    check(err <= DEMOD_RTOL, f"sharded frontend max|diff|/max|ref| "
          f"{err:.2e} <= {DEMOD_RTOL:.0e}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded paths, on four cards")
    args = p.parse_args(argv)

    import jax

    from srsue_tpu.utils.jaxutil import (card_line, require_gpu,
                                         use_compile_cache)

    use_compile_cache()
    dev = require_gpu()
    n_dev = len(jax.devices())
    log(card_line())
    log(f"device_kind: {dev.device_kind}; devices: {n_dev}")
    t0 = time.perf_counter()
    if args.four:
        if n_dev < 4:
            raise SystemExit(f"--four needs 4 GPUs, found {n_dev}")
        run_four_cards(4, B=256)
    else:
        run_one_card(dev, B=256)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": n_dev}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
