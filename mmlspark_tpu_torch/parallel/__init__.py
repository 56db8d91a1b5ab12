from mmlspark_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS,
                                              Mesh, MeshSpec, make_mesh)
from mmlspark_tpu_torch.parallel.partition import (DEFAULT_RULES,
                                                   SEQ_KV_CACHE_SPEC,
                                                   SEQ_KV_SCALE_SPEC,
                                                   rules_from_json,
                                                   rules_to_json)
from mmlspark_tpu_torch.parallel.ring import (make_seq_parallel_lm_step,
                                              pmax, ppermute, psum, reshard,
                                              seq_parallel_attention, shard,
                                              shard_tokens, unshard,
                                              use_seq_mesh)
