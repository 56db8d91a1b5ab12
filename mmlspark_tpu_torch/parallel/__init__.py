from mmlspark_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS,
                                              Mesh, MeshSpec, make_mesh)
from mmlspark_tpu_torch.parallel.partition import (DEFAULT_RULES,
                                                   SEQ_KV_CACHE_SPEC,
                                                   SEQ_KV_SCALE_SPEC,
                                                   rules_from_json,
                                                   rules_to_json)
from mmlspark_tpu_torch.parallel.ring import (pmax, ppermute, psum, reshard,
                                              seq_parallel_attention, shard,
                                              unshard)
