from mmlspark_tpu_torch.zoo.downloader import (LocalRepo, ModelDownloader,
                                               ModelNotFoundError,
                                               ModelSchema, RemoteRepo,
                                               create_builtin_repo,
                                               pack_bundle, pretrained_repo,
                                               sha256_file, unpack_bundle)
from mmlspark_tpu_torch.zoo.speculative import (soften_late_blocks,
                                                truncated_draft_bundle)

__all__ = ["LocalRepo", "ModelDownloader", "ModelNotFoundError",
           "ModelSchema", "RemoteRepo", "create_builtin_repo", "pack_bundle",
           "pretrained_repo", "sha256_file", "unpack_bundle",
           "soften_late_blocks", "truncated_draft_bundle"]
