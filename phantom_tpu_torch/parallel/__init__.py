"""The multi-device layer over torch.distributed (counterpart of
phantom_tpu/parallel): the coefficient-sharded CKKS, BGV and BFV steps
(the ("dp", "coeff") layout) and the limb-sharded CKKS step (the ("dp",
"limb") layout).

Every polynomial's coefficients are split over the ranks of a "coeff"
group (mesh.py); every stage of a step is local to a coefficient except
the NTTs, whose two phases run locally (P1, csrc/ntt_phase.cu) around
all-to-alls over the group (ntt_sharded.py).  NCCL carries them on the
card, one rank a card; gloo on the CPU.  launch.py starts the ranks.

In the ("dp", "limb") layout (make_mesh, ct_sharding, replicate,
shard_ciphertext_data, sharded_mul_relin_rescale_step) a rank holds a
block of every ciphertext's RNS rows, all coefficients of each; the
multiply + relinearize + rescale step runs U1-U4 on the rank's rows, with
all-gathers of c2, of the moddown's P rows and of the result and a
broadcast of the rescaled-away row over the limb group (limb_step.py).
"""

from .limb_step import LimbStepConsts  # noqa: F401
from .mesh import (CoeffMesh, LimbMesh, Placement,  # noqa: F401
                   ct_sharding, gather_coeff, make_coeff_mesh, make_mesh,
                   replicate, shard_batch, shard_ciphertext_data,
                   shard_coeff, sharded_mul_relin_rescale_step)
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
