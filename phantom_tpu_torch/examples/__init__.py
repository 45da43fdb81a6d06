"""Self-checking examples of the port (counterparts of examples/7, 9 and
11 of the JAX package, their Fast32 halves); each raises on a wrong
decryption.  Run one as a script, on the CUDA device by default:

    python phantom_tpu_torch/examples/mlp_inference.py [--device cpu]
"""
