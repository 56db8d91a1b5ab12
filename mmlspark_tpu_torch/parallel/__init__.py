from mmlspark_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS,
                                              MeshSpec)
from mmlspark_tpu_torch.parallel.partition import (DEFAULT_RULES,
                                                   rules_from_json,
                                                   rules_to_json)
