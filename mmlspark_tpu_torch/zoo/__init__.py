from mmlspark_tpu_torch.zoo.speculative import (soften_late_blocks,
                                                truncated_draft_bundle)

__all__ = ["soften_late_blocks", "truncated_draft_bundle"]
