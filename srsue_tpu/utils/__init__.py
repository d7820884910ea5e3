"""Common runtime utilities (the analogue of the reference's
ue/src/common: config, logging, metrics, buffer/packet helpers, JAX helpers).
"""
