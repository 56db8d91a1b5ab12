from mmlspark_tpu_torch._lazy import lazy_exports

# every module here but prefetch imports torch: the names resolve on
# first use (`_lazy.py`), so the data layer's Prefetcher imports none of it
_EXPORTS = {
    **dict.fromkeys(("gather_to_host", "pad_to_multiple", "shard_batch",
                     "shard_table_columns"),
                    "mmlspark_tpu_torch.parallel.bridge"),
    **dict.fromkeys(("DistributedConfig", "initialize_distributed"),
                    "mmlspark_tpu_torch.parallel.distributed"),
    **dict.fromkeys(("DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "Mesh",
                     "MeshSpec", "best_mesh", "default_mesh", "make_mesh",
                     "mesh_spec_from_config"),
                    "mmlspark_tpu_torch.parallel.mesh"),
    **dict.fromkeys(("DEFAULT_RULES", "SEQ_KV_CACHE_SPEC",
                     "SEQ_KV_SCALE_SPEC", "gather_tree", "make_gather_fns",
                     "make_shard_fns", "match_partition_rules",
                     "rules_from_json", "rules_to_json", "shard_tree"),
                    "mmlspark_tpu_torch.parallel.partition"),
    **dict.fromkeys(("make_seq_parallel_lm_step", "pmax", "ppermute", "psum",
                     "reshard", "seq_parallel_attention", "shard",
                     "shard_tokens", "unshard", "use_seq_mesh"),
                    "mmlspark_tpu_torch.parallel.ring"),
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
