from mmlspark_tpu_torch.ops.attention import (NEG_INF, attention,
                                              single_query_attention,
                                              single_query_attention_stats)
from mmlspark_tpu_torch.ops.decode_attention import (
    fused_single_query_attention, fused_single_query_attention_plain)
from mmlspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_plain)
