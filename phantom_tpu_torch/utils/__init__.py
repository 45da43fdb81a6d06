"""Wire formats, the reference's Salsa20 sampler (S1), timers and the range
sanitizer (counterpart of phantom_tpu/utils/, without the JAX bench's
setup cache)."""
