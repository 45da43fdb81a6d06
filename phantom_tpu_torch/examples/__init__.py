"""Self-checking examples of the port (counterparts of examples/1-3 and
6-11 of the JAX package: 7 and 9 on Fast32, 11 on Fast32 and on the u64
evaluator, the others on the u64 evaluator); each raises on a wrong
decryption.  Run one as a script, on the CUDA device by default:

    python phantom_tpu_torch/examples/mlp_inference.py [--device cpu]
"""
