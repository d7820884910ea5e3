"""srsue_tpu — an LTE Release-8 FDD UE framework in JAX.

A from-scratch re-design of the capabilities of srsUE (reference:
/root/reference, see SURVEY.md) as batched accelerator programs:

* ``srsue_tpu.phy``  — the full DL receive chain and UL transmit chain as
  batched JAX/XLA/Pallas kernels (OFDM, sync, channel estimation,
  equalization, demapping, rate (de)matching, turbo/Viterbi codecs,
  PBCH/PCFICH/PHICH/PDCCH/PDSCH, PRACH/PUSCH/PUCCH/SRS).
* ``srsue_tpu.mac`` / ``rlc`` / ``pdcp`` / ``rrc`` / ``nas`` / ``usim`` /
  ``gw`` — the host-side protocol stack orchestrating the device kernels
  (HARQ, random access, logical channels, security, attach).
* ``srsue_tpu.parallel`` — device-mesh sharding of batched carriers/UEs
  (the device-mesh replacement of the reference's 2-4 thread TTI pipeline,
  ``ue/src/phy/phch_recv.cc``).
* ``srsue_tpu.radio`` — radio abstractions (file/IQ-trace radio standing in
  for the reference's UHD front-end, ``ue/src/radio/radio_uhd.cc``).

Everything on the device side is batch-first: arrays carry a leading
``[batch, ...]`` axis of independent subframes/carriers/UEs and all shapes
are static per (bandwidth, MCS) bucket so XLA compiles one program each.
"""

__version__ = "0.1.0"
