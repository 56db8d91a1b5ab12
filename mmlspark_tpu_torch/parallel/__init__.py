from mmlspark_tpu_torch.parallel.bridge import (gather_to_host,
                                                pad_to_multiple, shard_batch,
                                                shard_table_columns)
from mmlspark_tpu_torch.parallel.distributed import (DistributedConfig,
                                                     initialize_distributed)
from mmlspark_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS,
                                              Mesh, MeshSpec, best_mesh,
                                              default_mesh, make_mesh,
                                              mesh_spec_from_config)
from mmlspark_tpu_torch.parallel.partition import (DEFAULT_RULES,
                                                   SEQ_KV_CACHE_SPEC,
                                                   SEQ_KV_SCALE_SPEC,
                                                   gather_tree,
                                                   make_gather_fns,
                                                   make_shard_fns,
                                                   match_partition_rules,
                                                   rules_from_json,
                                                   rules_to_json, shard_tree)
from mmlspark_tpu_torch.parallel.ring import (make_seq_parallel_lm_step,
                                              pmax, ppermute, psum, reshard,
                                              seq_parallel_attention, shard,
                                              shard_tokens, unshard,
                                              use_seq_mesh)
