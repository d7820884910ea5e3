"""PHY layer: batched JAX/XLA/Pallas DSP kernels for the LTE DL/UL chains.

Mirrors the capability surface the reference consumes from srsLTE
(SURVEY.md §2.1 "srsLTE DSP API surface") but re-designed for batched accelerators:
pure functions over ``[batch, ...]`` arrays, static shapes, host-side
numpy precompute of all config-dependent index maps and sequences.
"""
