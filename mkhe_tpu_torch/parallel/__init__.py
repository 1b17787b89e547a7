"""The parallel tier over torch.distributed (port of mkhe_tpu/parallel):
the ranks' mesh and placements (mesh.py), the coefficient-sharded NTT
(dist_ntt.py) and mult (coeff_mul.py), the party-sharded mult and rotation
(party_mul.py), over the collectives of comm.py.

Every function here is SPMD: each rank of the process group calls it with
its own block, after torch.distributed.init_process_group (by torchrun, or
by torch.multiprocessing as _ranks.py does for the tests and
chip_smoke.py). The sharded paths run eagerly; a collective inside a CUDA
graph capture (fuse.py) raises.
"""

from .mesh import (make_mesh, ciphertext_sharding, key_sharding,
                   shard_ciphertext, shard_rlk_stacked, shard_params)

__all__ = ["make_mesh", "ciphertext_sharding", "key_sharding",
           "shard_ciphertext", "shard_rlk_stacked", "shard_params"]
