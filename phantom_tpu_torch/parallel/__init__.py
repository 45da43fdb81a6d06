"""The multi-device layer: the coefficient-sharded CKKS, BGV and BFV
steps over torch.distributed (counterpart of phantom_tpu/parallel, its
("dp", "coeff") layout).

Every polynomial's coefficients are split over the ranks of a "coeff"
group (mesh.py); every stage of a step is local to a coefficient except
the NTTs, whose two phases run locally (P1, csrc/ntt_phase.cu) around
all-to-alls over the group (ntt_sharded.py).  NCCL carries them on the
card, one rank a card; gloo on the CPU.  launch.py starts the ranks.
The ("dp", "limb") layout of the JAX package (make_mesh, ct_sharding,
replicate, sharded_mul_relin_rescale_step) is not ported.
"""

from .mesh import (CoeffMesh, gather_coeff, make_coeff_mesh,  # noqa: F401
                   shard_batch, shard_coeff)
from .ntt_sharded import (ShardedNTTTables,  # noqa: F401
                          ShardedNTTTables32, ntt_forward_sharded,
                          ntt_forward_sharded3, ntt_inverse_sharded,
                          ntt_inverse_sharded3, ntt_phase,
                          prepare_sharded_tables, prepare_sharded_tables32)
from .pipeline_sharded import (BFVShardedConsts,  # noqa: F401
                               ShardedPipelineConsts,
                               build_bfv_sharded_consts,
                               build_sharded_consts, build_sharded_step,
                               sharded_bfv_mult_relin,
                               sharded_bgv_mult_relin_modswitch,
                               sharded_mult_relin_rescale)
from .sharded32 import (Sharded32Consts, build_sharded32,  # noqa: F401
                        build_sharded_step32, sharded_mult_relin_rescale32)
