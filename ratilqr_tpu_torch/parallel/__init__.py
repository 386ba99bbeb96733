"""The distributed layer: the sample axis over the ranks of a process
group (``mesh``) and the sharded θ-bank, PETS and fleets (``sharded``)."""
from ratilqr_tpu_torch.parallel.mesh import (SAMPLE_AXIS,
                                             distributed_initialize,
                                             make_mesh, replicated,
                                             sample_sharding)
from ratilqr_tpu_torch.parallel.sharded import (compute_cost_shard_map,
                                                make_sharded_fleet_runner,
                                                make_sharded_pets_solve,
                                                make_sharded_theta_cost_fn,
                                                sharded_elite_selection)
