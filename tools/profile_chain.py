"""Per-stage profile of the flagship 20 MHz 64QAM PDSCH chain on the
GPU (cumulative-prefix marginals; a device trace attributes better).

Times cumulative prefixes of the chain as separately-jitted programs:
    P0 demod | P1 +chest | P2 +eq/extract | P3 +demap+dematch
    P4 +turbo(1 iter, forced) | P5 +turbo(8 iters, forced)
    P6 full decode w/ early exit
Marginal cost of a stage = difference of adjacent prefixes; per-turbo-
iteration cost = (P5-P4)/7. Every timed rep ends in block_until_ready.

Usage: python tools/profile_chain.py [B]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 256

    import jax
    import jax.numpy as jnp

    from bench import SNR_OPERATING, add_noise, build_clean
    from srsue_tpu.phy import chest, equalize, ofdm
    from srsue_tpu.phy.pdsch import PdschCodec
    from srsue_tpu.utils.jaxutil import (iq_complex, iq_pairs, require_gpu,
                                         use_compile_cache)

    use_compile_cache()
    require_gpu()

    (cell, grant, subframe, cfi, rnti, dci_bits, payloads, td, p_sig,
     rng) = build_clean(B)
    noisy = add_noise(rng, td, p_sig, SNR_OPERATING)
    codec = PdschCodec(cell, grant, rnti=rnti, subframe=subframe, cfi=cfi,
                       n_turbo_iters=8)
    codec1 = PdschCodec(cell, grant, rnti=0x1234, subframe=subframe, cfi=1,
                        n_turbo_iters=1, early_exit=False)
    codec8 = PdschCodec(cell, grant, rnti=0x1234, subframe=subframe, cfi=1,
                        n_turbo_iters=8, early_exit=False)

    def probe(x):
        return (jnp.zeros((8, 128), jnp.float32)
                .at[0, 0].set(jnp.sum(jnp.abs(x).astype(jnp.float32))))

    def p0(iq_p):
        grid = ofdm.demodulate(cell, iq_complex(iq_p))
        return probe(grid)

    def p1(iq_p):
        grid = ofdm.demodulate(cell, iq_complex(iq_p))
        h, nvar, _ = chest.estimate(cell, grid, subframe, port=0)
        return probe(h) + probe(nvar)

    def p2(iq_p):
        grid = ofdm.demodulate(cell, iq_complex(iq_p))
        h, nvar, _ = chest.estimate(cell, grid, subframe, port=0)
        x_eq, nv = equalize.zf(codec.extract_re(grid), codec.extract_re(h),
                               nvar)
        return probe(x_eq) + probe(nv)

    def p3(iq_p):
        grid = ofdm.demodulate(cell, iq_complex(iq_p))
        h, nvar, _ = chest.estimate(cell, grid, subframe, port=0)
        x_eq, nv = equalize.zf(codec.extract_re(grid), codec.extract_re(h),
                               nvar)
        bufs = codec.dematch(codec.demap_llrs(x_eq, nv))
        return sum(probe(b) for b in bufs)

    def mk_turbo(c):
        def f(iq_p):
            grid = ofdm.demodulate(cell, iq_complex(iq_p))
            h, nvar, _ = chest.estimate(cell, grid, subframe, port=0)
            x_eq, nv = equalize.zf(codec.extract_re(grid),
                                   codec.extract_re(h), nvar)
            payload, tb_ok, _, iters = c.decode(x_eq, nv)
            return (probe(payload)
                    .at[0, 1].set(jnp.sum(tb_ok.astype(jnp.float32)))
                    .at[0, 2].set(jnp.mean(iters.astype(jnp.float32))))
        return f

    stages = [
        ("P0 demod", p0),
        ("P1 +chest", p1),
        ("P2 +eq", p2),
        ("P3 +demap+dematch", p3),
        ("P4 +turbo1f", mk_turbo(codec1)),
        ("P5 +turbo8f", mk_turbo(codec8)),
        ("P6 full-ee", mk_turbo(codec)),
    ]

    iq = jnp.asarray(iq_pairs(noisy))
    results = {}
    n_rep = 6
    for name, fn in stages:
        jf = jax.jit(fn)
        t0 = time.perf_counter()
        out = np.asarray(jf(iq))
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n_rep):
            res = jax.block_until_ready(jf(iq))
        dt = (time.perf_counter() - t0) / n_rep * 1e3
        out = np.asarray(res)
        results[name] = dt
        print(f"{name:22s} {dt:9.2f} ms  (compile {t_compile:.1f}s, "
              f"probe {out[0,0]:.3g} ok={out[0,1]:.0f} it={out[0,2]:.2f})",
              flush=True)

    keys = list(results)
    print("\nmarginals:")
    prev = 0.0
    for k in keys:
        print(f"  {k:22s} +{results[k]-prev:9.2f} ms")
        prev = results[k]
    per_iter = (results["P5 +turbo8f"] - results["P4 +turbo1f"]) / 7
    print(f"\nturbo per-iteration: {per_iter:.2f} ms "
          f"({per_iter/B*1e3:.1f} us/sf)")
    t8 = results["P5 +turbo8f"]
    print(f"8-iter forced total: {t8:.2f} ms -> "
          f"{B*grant.tbs/t8/1e3:.1f} Mbps")


if __name__ == "__main__":
    main()
